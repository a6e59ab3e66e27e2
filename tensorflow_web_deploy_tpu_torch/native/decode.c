/* Host-side decode for the port's serving path: JPEG -> wire bytes, in one
 * pass, with libjpeg.
 *
 * Entropy-coded image decode is the one compute stage of the request path
 * that stays on the host. These entries drive libjpeg straight into the
 * engine's wire formats:
 *
 *   - twd_jpeg_dims():          header-only probe, so the caller picks the
 *                               canvas bucket before allocating anything.
 *   - twd_decode_jpeg():        decode + DCT-domain downscale (1/2, 1/4,
 *                               1/8 -- near-free for oversized uploads)
 *                               into an RGB canvas [S,S,3] or a packed
 *                               I420 canvas [3S/2,S] (the yuv420 wire,
 *                               1.5 B/px), zero/neutral-padded.
 *   - twd_decode_jpeg_slot():   the same into a caller's row of a shared
 *                               buffer, capacity checked first, with the
 *                               wire's optional 4-byte (h, w) trailer.
 *   - twd_decode_jpeg_packed(): tight RGB rows (stride w*3, no padding)
 *                               for the ragged wire's byte arena.
 *   - twd_jpeg_lib_version():   JPEG_LIB_VERSION of the libjpeg it was
 *                               built against (reported by chip_smoke.py).
 *
 * Single-threaded per call; Python calls it from request threads through
 * ctypes.CDLL, which releases the interpreter lock for the call, so decode
 * parallelism comes from the serving threads themselves.
 *
 * Return codes: 0 ok; -1 bad/corrupt JPEG; -2 image too large for the
 * canvas even at 1/8 scale; -3 unsupported colorspace (caller falls back
 * to the PIL path); -4 bad arguments or an undersized destination.
 */

#include <setjmp.h>
#include <stddef.h>
#include <stdio.h> /* jpeglib.h needs FILE declared first */
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

struct twd_err_mgr {
  struct jpeg_error_mgr pub;
  jmp_buf jb;
};

static void twd_error_exit(j_common_ptr cinfo) {
  struct twd_err_mgr *err = (struct twd_err_mgr *)cinfo->err;
  longjmp(err->jb, 1);
}

static void twd_emit_message(j_common_ptr cinfo, int msg_level) {
  (void)cinfo;
  (void)msg_level; /* stay silent: servers must not spray stderr */
}

int twd_jpeg_lib_version(void) { return JPEG_LIB_VERSION; }

int twd_jpeg_dims(const unsigned char *data, size_t len, int *h, int *w) {
  struct jpeg_decompress_struct cinfo;
  struct twd_err_mgr jerr;

  if (!data || !len || !h || !w) return -4;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = twd_error_exit;
  jerr.pub.emit_message = twd_emit_message;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, (unsigned char *)data, (unsigned long)len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  *h = (int)cinfo.image_height;
  *w = (int)cinfo.image_width;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

/* Pick the smallest DCT scale denominator in {1,2,4,8} that fits the image
 * inside the canvas; returns 0 if even 1/8 cannot fit. */
static int pick_denom(int h, int w, int canvas) {
  int d;
  int m = h > w ? h : w;
  for (d = 1; d <= 8; d *= 2) {
    if ((m + d - 1) / d <= canvas) return d;
  }
  return 0;
}

int twd_decode_jpeg(const unsigned char *data, size_t len, unsigned char *out,
                    int canvas, int wire, int *out_h, int *out_w) {
  struct jpeg_decompress_struct cinfo;
  struct twd_err_mgr jerr;
  /* volatile: assigned between setjmp and a possible longjmp (C11
   * 7.13.2.1) — without it the done: frees would see indeterminate
   * pointers after a libjpeg error_exit on a corrupt stream. */
  JSAMPLE *volatile row = NULL;
  unsigned short *volatile usum = NULL, *volatile vsum = NULL;
  int rc = -1;

  if (!data || !len || !out || !out_h || !out_w) return -4;
  if (canvas <= 0 || (wire == 1 && (canvas & 3))) return -4;

  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = twd_error_exit;
  jerr.pub.emit_message = twd_emit_message;
  if (setjmp(jerr.jb)) {
    rc = -1;
    goto done;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, (unsigned char *)data, (unsigned long)len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) goto done;

  {
    int denom = pick_denom((int)cinfo.image_height, (int)cinfo.image_width, canvas);
    if (!denom) {
      rc = -2;
      goto done;
    }
    cinfo.scale_num = 1;
    cinfo.scale_denom = (unsigned int)denom;
  }

  /* Grayscale sources can't be converted to YCbCr by libjpeg; decode them
   * as grayscale and synthesize neutral chroma below. Everything else goes
   * through libjpeg's color machinery. */
  if (cinfo.jpeg_color_space == JCS_GRAYSCALE) {
    cinfo.out_color_space = JCS_GRAYSCALE;
  } else if (wire == 1) {
    cinfo.out_color_space = JCS_YCbCr;
  } else {
    cinfo.out_color_space = JCS_RGB;
  }
  if (cinfo.jpeg_color_space == JCS_CMYK || cinfo.jpeg_color_space == JCS_YCCK) {
    rc = -3;
    goto done;
  }

  jpeg_start_decompress(&cinfo);
  {
    const int w = (int)cinfo.output_width;
    const int h = (int)cinfo.output_height;
    const int comps = (int)cinfo.output_components;
    const int gray = (cinfo.out_color_space == JCS_GRAYSCALE);
    if (w > canvas || h > canvas) {
      jpeg_abort_decompress(&cinfo);
      rc = -2;
      goto done;
    }
    row = (JSAMPLE *)malloc((size_t)w * (size_t)comps);
    if (!row) goto done;

    if (wire == 0) {
      /* RGB canvas [S,S,3], zero padding. */
      memset(out, 0, (size_t)canvas * (size_t)canvas * 3u);
      while (cinfo.output_scanline < cinfo.output_height) {
        int y = (int)cinfo.output_scanline;
        unsigned char *dst = out + (size_t)y * (size_t)canvas * 3u;
        JSAMPROW rp = (JSAMPROW)row;
        jpeg_read_scanlines(&cinfo, &rp, 1);
        if (gray) {
          int x;
          for (x = 0; x < w; x++) {
            dst[3 * x] = dst[3 * x + 1] = dst[3 * x + 2] = row[x];
          }
        } else {
          memcpy(dst, row, (size_t)w * 3u);
        }
      }
    } else {
      /* Packed I420 [3S/2, S]: Y plane then S/4-row U and V planes.
       * Chroma cells are FULL 2x2-cell means: samples outside the valid
       * region count as neutral chroma (128), exactly like a zero-padded
       * RGB canvas packed by the Python reference packer (zero RGB ->
       * U=V=128), so boundary cells agree bit-for-bit with that path.
       * Padding stays Y=0, U=V=128. */
      const int s2 = canvas / 2;
      unsigned char *yplane = out;
      unsigned char *uplane = out + (size_t)canvas * (size_t)canvas;
      unsigned char *vplane = uplane + (size_t)s2 * (size_t)s2;
      memset(yplane, 0, (size_t)canvas * (size_t)canvas);
      memset(uplane, 128, (size_t)s2 * (size_t)s2 * 2u);
      usum = (unsigned short *)calloc((size_t)s2 * (size_t)s2, sizeof *usum);
      vsum = (unsigned short *)calloc((size_t)s2 * (size_t)s2, sizeof *vsum);
      if (!usum || !vsum) goto done;
      while (cinfo.output_scanline < cinfo.output_height) {
        int y = (int)cinfo.output_scanline;
        int x;
        unsigned char *ydst = yplane + (size_t)y * (size_t)canvas;
        JSAMPROW rp = (JSAMPROW)row;
        jpeg_read_scanlines(&cinfo, &rp, 1);
        if (gray) {
          memcpy(ydst, row, (size_t)w);
        } else {
          const int cy = y >> 1;
          for (x = 0; x < w; x++) {
            const size_t cell = (size_t)cy * (size_t)s2 + (size_t)(x >> 1);
            ydst[x] = row[3 * x];
            usum[cell] += row[3 * x + 1];
            vsum[cell] += row[3 * x + 2];
          }
        }
      }
      if (!gray) {
        int cy, cx;
        for (cy = 0; cy < (h + 1) / 2; cy++) {
          const int ny = h - 2 * cy >= 2 ? 2 : 1;
          for (cx = 0; cx < (w + 1) / 2; cx++) {
            const int nx = w - 2 * cx >= 2 ? 2 : 1;
            const size_t cell = (size_t)cy * (size_t)s2 + (size_t)cx;
            const int n = ny * nx;
            /* Box-mean over the FULL 2x2 cell: missing samples (odd h/w
             * boundary) count as neutral chroma 128, exactly like the
             * Python packer's full-canvas mean over the padded canvas. */
            uplane[cell] = (unsigned char)((usum[cell] + (4 - n) * 128 + 2) / 4);
            vplane[cell] = (unsigned char)((vsum[cell] + (4 - n) * 128 + 2) / 4);
          }
        }
      }
    }
    *out_h = h;
    *out_w = w;
  }
  jpeg_finish_decompress(&cinfo);
  rc = 0;

done:
  free((void *)row);
  free((void *)usum);
  free((void *)vsum);
  jpeg_destroy_decompress(&cinfo);
  return rc;
}

/* Decode into a caller's row of a SHARED staging buffer: the same decode
 * as twd_decode_jpeg, but (a) the row's capacity is checked up front (an
 * overrun would corrupt a neighbouring request's row, not just this
 * image), and (b) with trailer != 0 the wire's 4-byte big-endian (h, w)
 * trailer is written right after the canvas bytes, so one call stages a
 * wire row completely. Return codes as twd_decode_jpeg; -4 also covers an
 * undersized row. */
int twd_decode_jpeg_slot(const unsigned char *data, size_t len,
                         unsigned char *out, size_t out_cap, int canvas,
                         int wire, int trailer, int *out_h, int *out_w) {
  size_t canvas_bytes;
  int rc;

  if (!out || canvas <= 0) return -4;
  canvas_bytes = (wire == 1) ? (size_t)canvas * (size_t)canvas * 3u / 2u
                             : (size_t)canvas * (size_t)canvas * 3u;
  if (out_cap < canvas_bytes + (trailer ? 4u : 0u)) return -4;
  rc = twd_decode_jpeg(data, len, out, canvas, wire, out_h, out_w);
  if (rc == 0 && trailer) {
    unsigned char *t = out + canvas_bytes;
    t[0] = (unsigned char)((*out_h >> 8) & 0xFF);
    t[1] = (unsigned char)(*out_h & 0xFF);
    t[2] = (unsigned char)((*out_w >> 8) & 0xFF);
    t[3] = (unsigned char)(*out_w & 0xFF);
  }
  return rc;
}

/* Ragged-wire entry: decode to TIGHT rows (stride w*3, RGB only, no canvas
 * padding) into a bump-allocated span of a shared byte arena. No memset —
 * every byte of the h*w*3 span is written. max_side bounds the decoded
 * extent exactly like the canvas argument above (DCT-domain 1/2-1/4-1/8
 * downscale for oversized sources), so the decoded image is guaranteed to
 * fit the canvas bucket the device-side unpack targets. The capacity check
 * runs after jpeg_start_decompress (output dims known) and before any
 * write: an overrun here would corrupt a NEIGHBORING image's bytes in the
 * shared arena. Return codes as twd_decode_jpeg; -4 also covers an
 * undersized span. */
int twd_decode_jpeg_packed(const unsigned char *data, size_t len,
                           unsigned char *out, size_t out_cap, int max_side,
                           int *out_h, int *out_w) {
  struct jpeg_decompress_struct cinfo;
  struct twd_err_mgr jerr;
  JSAMPLE *volatile row = NULL;
  int rc = -1;

  if (!data || !len || !out || !out_h || !out_w) return -4;
  if (max_side <= 0) return -4;

  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = twd_error_exit;
  jerr.pub.emit_message = twd_emit_message;
  if (setjmp(jerr.jb)) {
    rc = -1;
    goto done;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, (unsigned char *)data, (unsigned long)len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) goto done;

  {
    int denom = pick_denom((int)cinfo.image_height, (int)cinfo.image_width, max_side);
    if (!denom) {
      rc = -2;
      goto done;
    }
    cinfo.scale_num = 1;
    cinfo.scale_denom = (unsigned int)denom;
  }

  if (cinfo.jpeg_color_space == JCS_GRAYSCALE) {
    cinfo.out_color_space = JCS_GRAYSCALE;
  } else {
    cinfo.out_color_space = JCS_RGB;
  }
  if (cinfo.jpeg_color_space == JCS_CMYK || cinfo.jpeg_color_space == JCS_YCCK) {
    rc = -3;
    goto done;
  }

  jpeg_start_decompress(&cinfo);
  {
    const int w = (int)cinfo.output_width;
    const int h = (int)cinfo.output_height;
    const int comps = (int)cinfo.output_components;
    const int gray = (cinfo.out_color_space == JCS_GRAYSCALE);
    if (w > max_side || h > max_side ||
        out_cap < (size_t)h * (size_t)w * 3u) {
      jpeg_abort_decompress(&cinfo);
      rc = -4;
      if (w > max_side || h > max_side) rc = -2;
      goto done;
    }
    row = (JSAMPLE *)malloc((size_t)w * (size_t)comps);
    if (!row) goto done;

    while (cinfo.output_scanline < cinfo.output_height) {
      int y = (int)cinfo.output_scanline;
      unsigned char *dst = out + (size_t)y * (size_t)w * 3u;
      JSAMPROW rp = (JSAMPROW)row;
      jpeg_read_scanlines(&cinfo, &rp, 1);
      if (gray) {
        int x;
        for (x = 0; x < w; x++) {
          dst[3 * x] = dst[3 * x + 1] = dst[3 * x + 2] = row[x];
        }
      } else {
        memcpy(dst, row, (size_t)w * 3u);
      }
    }
    *out_h = h;
    *out_w = w;
  }
  jpeg_finish_decompress(&cinfo);
  rc = 0;

done:
  free((void *)row);
  jpeg_destroy_decompress(&cinfo);
  return rc;
}
