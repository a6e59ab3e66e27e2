"""Photos and request bodies made from the seed.

A traffic mix names a generator (:data:`GENERATORS`) and the photo sizes.
The pool holds ``pool_per_size`` distinct JPEGs of each size. Each call of
the mix holds the same number of photos of every size, drawn from the pool
in a seeded order, so that every seed sends the same pixels' worth of work
in another order. The multipart body is the one ``tools/loadgen.py::
make_payload`` builds (a boundary found in no photo, one file part a
photo), so the server parses what real batch uploads send.
"""

from __future__ import annotations

import io
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from .weights import rng


@dataclass(frozen=True)
class Photo:
    jpeg: bytes
    h: int
    w: int


def smooth_edges(h: int, w: int, g: np.random.Generator) -> np.ndarray:
    """A photo-like RGB uint8 image: a smooth two-colour gradient behind
    4–7 rectangles and ellipses with hard edges, each shaded top to bottom,
    and mild sensor noise. Its JPEG costs a decoder what a photo of smooth
    regions and edges costs, not what white noise would."""
    c0, c1 = g.uniform(20, 235, (2, 3)).astype(np.float32)
    angle = g.uniform(0, np.pi)
    t = (np.linspace(0, np.sin(angle), h, dtype=np.float32)[:, None]
         + np.linspace(0, np.cos(angle), w, dtype=np.float32)[None, :])
    t = (t - t.min()) / max(float(t.max() - t.min()), 1e-6)
    img = c0 + (c1 - c0) * t[..., None]
    for _ in range(int(g.integers(4, 8))):
        cy, cx = g.uniform(0, h), g.uniform(0, w)
        ry, rx = g.uniform(0.08, 0.35) * h, g.uniform(0.08, 0.35) * w
        y0, y1 = int(max(0, cy - ry)), int(min(h, cy + ry + 1))
        x0, x1 = int(max(0, cx - rx)), int(min(w, cx + rx + 1))
        if y1 <= y0 or x1 <= x0:
            continue
        colour = g.uniform(20, 235, 3).astype(np.float32)
        shade = np.linspace(0.85, 1.15, y1 - y0, dtype=np.float32)[:, None, None]
        block = img[y0:y1, x0:x1]
        if g.random() < 0.5:
            block[:] = colour * shade
        else:
            yy = (np.arange(y0, y1, dtype=np.float32)[:, None] - cy) / ry
            xx = (np.arange(x0, x1, dtype=np.float32)[None, :] - cx) / rx
            inside = (yy * yy + xx * xx < 1.0)[..., None]
            np.copyto(block, colour * shade, where=inside)
    img += g.integers(-4, 5, (h, w, 1), dtype=np.int16) + np.float32(0.5)
    return np.clip(img, 0, 255, out=img).astype(np.uint8)


GENERATORS = {"smooth_edges": smooth_edges}


def encode_jpeg(img: np.ndarray, quality: int) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def make_pool(traffic: dict, seed: int, threads: int = 4) -> list[Photo]:
    """``pool_per_size`` photos of each of the mix's sizes ([w, h] pairs),
    size-major; photo ``i`` from a generator of its own, so that the
    threads that make them leave the pool as it is."""
    make = GENERATORS[traffic["generator"]]
    shapes = [(h, w) for w, h in traffic["sizes"] for _ in range(traffic["pool_per_size"])]

    def one(i: int) -> Photo:
        h, w = shapes[i]
        return Photo(encode_jpeg(make(h, w, rng(seed, 2, i)), traffic["jpeg_quality"]), h, w)

    with ThreadPoolExecutor(threads) as ex:
        return list(ex.map(one, range(len(shapes))))


def make_calls(traffic: dict, seed: int) -> list[list[int]]:
    """``calls`` lists of ``photos_per_call`` pool indices. The photos' sizes
    take turns over all the calls' photos, so that every size is sent alike
    (each call holds as many of every size when ``photos_per_call`` is a
    multiple of the sizes); within a size the photo is drawn from the seed,
    and a call's photos are distinct and shuffled."""
    sizes, per, n = len(traffic["sizes"]), traffic["pool_per_size"], traffic["photos_per_call"]
    g = rng(seed, 3)
    calls, turn = [], 0
    for _ in range(traffic["calls"]):
        call = []
        while len(call) < n:
            i = (turn % sizes) * per + int(g.integers(per))
            if i not in call:
                call.append(i)
                turn += 1
        calls.append([int(i) for i in g.permutation(call)])
    return calls


def body(jpegs: list[bytes]) -> tuple[bytes, str]:
    """(body, content type) of one call: a photo alone as a raw JPEG body,
    several as one multipart upload."""
    return (jpegs[0], "image/jpeg") if len(jpegs) == 1 else multipart(jpegs)


def multipart(jpegs: list[bytes]) -> tuple[bytes, str]:
    """(body, content type) of one multipart upload of ``jpegs``."""
    n = 0
    while True:
        boundary = f"loadgenboundary{n}"
        if all(b"--" + boundary.encode() not in c for c in jpegs):
            break
        n += 1
    parts = b"".join(
        (f"--{boundary}\r\n"
         f'Content-Disposition: form-data; name="f{i}"; filename="{i}.jpg"\r\n\r\n').encode()
        + c + b"\r\n"
        for i, c in enumerate(jpegs))
    return parts + f"--{boundary}--\r\n".encode(), f"multipart/form-data; boundary={boundary}"
