"""The plain reference of the benchmark's classifiers: decode, resize,
normalize, the forward pass and softmax, in plain PyTorch and NumPy.

It imports nothing of the program. :class:`Compute` runs the
architectures of ``arch.py`` on NCHW tensors: ``F.conv2d`` with the "SAME"
pads of the published TensorFlow models (the odd pad at the end), batch
norm from its running statistics (never folded), ReLU, the pools and the
dense head, in float32.

``precision="tf32"`` is the control: the same computation with every conv
and matmul in TF32 (the tensor cores on CUDA; on the CPU its operands are
rounded to TF32's 10-bit mantissa, which is what the tensor cores read).
"""

from __future__ import annotations

import io

import numpy as np
import torch
import torch.nn.functional as F

from .arch import ARCHS, INPUT_SIZE, same_pads

CAFFE_MEAN_BGR = (103.939, 116.779, 123.68)


def _tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 → the nearest value with TF32's 10-bit mantissa (ties away
    from zero on the magnitude's bits, as the tensor cores' conversion)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Compute:
    """Compute mode on NCHW float32 tensors, from flat parameters (numpy,
    in the export's layouts) moved to ``device`` once."""

    def __init__(self, params: dict[str, np.ndarray], bn_eps: float, device,
                 precision: str = "float32"):
        if precision not in ("float32", "tf32"):
            raise ValueError(f"precision must be float32 or tf32, got {precision!r}")
        self.eps = bn_eps
        self.emulate_tf32 = precision == "tf32" and torch.device(device).type != "cuda"
        self.p = {}
        for key, a in params.items():
            t = torch.from_numpy(np.asarray(a, np.float32))
            if t.dim() == 4:  # HWIO → OIHW
                t = t.permute(3, 2, 0, 1)
            self.p[key] = t.contiguous().to(device)

    def _mm_operand(self, t):
        return _tf32_round(t) if self.emulate_tf32 else t

    def conv(self, x, name, cout, k=(1, 1), stride=1, padding="SAME", act="relu"):
        if padding == "SAME":
            (pt, pb), (pl, pr) = (same_pads(x.shape[2], k[0], stride),
                                  same_pads(x.shape[3], k[1], stride))
            x = F.pad(x, (pl, pr, pt, pb))
        y = F.conv2d(self._mm_operand(x), self._mm_operand(self.p[f"params/{name}/conv/kernel"]),
                     stride=stride)
        mean, var = (self.p[f"batch_stats/{name}/bn/{leaf}"] for leaf in ("mean", "var"))
        scale, bias = (self.p[f"params/{name}/bn/{leaf}"] for leaf in ("scale", "bias"))
        col = lambda v: v[None, :, None, None]  # noqa: E731
        y = (y - col(mean)) / torch.sqrt(col(var) + self.eps) * col(scale) + col(bias)
        return F.relu(y) if act == "relu" else y

    def max_pool(self, x, padding="VALID"):
        if padding == "SAME":
            (pt, pb), (pl, pr) = same_pads(x.shape[2], 3, 2), same_pads(x.shape[3], 3, 2)
            x = F.pad(x, (pl, pr, pt, pb), value=float("-inf"))
        return F.max_pool2d(x, 3, 2)

    def avg_pool(self, x):
        # 3×3 stride 1, zero-padded, every window divided by 9
        return F.avg_pool2d(F.pad(x, (1, 1, 1, 1)), 3, 1)

    def cat(self, xs):
        return torch.cat(xs, dim=1)

    def add_relu(self, a, b):
        return F.relu(a + b)

    def head(self, x, classes):
        pooled = x.mean(dim=(2, 3))
        kernel = self.p["params/logits/kernel"]
        return self._mm_operand(pooled) @ self._mm_operand(kernel) + self.p["params/logits/bias"]


# ------------------------------------------------------------- preprocess


def decode(jpeg: bytes) -> np.ndarray:
    """JPEG bytes → RGB uint8 [h, w, 3] (PIL, libjpeg's default IDCT)."""
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(jpeg)).convert("RGB"), dtype=np.uint8)


def _axis_taps(out: int, size: int):
    """Bilinear taps along one axis with half-pixel centres, the sample
    coordinate clamped into the image: (lo, hi, frac), float64."""
    c = (np.arange(out, dtype=np.float64) + 0.5) * (size / out) - 0.5
    c = np.clip(c, 0.0, size - 1.0)
    lo = np.floor(c)
    hi = np.minimum(lo + 1.0, size - 1.0)
    return lo.astype(np.int64), hi.astype(np.int64), c - lo


def resize(img: np.ndarray, out: int) -> np.ndarray:
    """uint8 [h, w, 3] → float64 [out, out, 3], rows first, then columns."""
    x = img.astype(np.float64)
    lo, hi, f = _axis_taps(out, x.shape[0])
    x = x[lo] * (1.0 - f)[:, None, None] + x[hi] * f[:, None, None]
    lo, hi, f = _axis_taps(out, x.shape[1])
    return x[:, lo] * (1.0 - f)[None, :, None] + x[:, hi] * f[None, :, None]


def normalize(x: np.ndarray, mode: str) -> np.ndarray:
    if mode == "inception":
        return x / 127.5 - 1.0
    if mode == "caffe":
        return x[..., ::-1] - np.asarray(CAFFE_MEAN_BGR)
    raise ValueError(f"unknown normalize mode {mode!r}")


def preprocess(jpegs: list[bytes], out: int, mode: str) -> np.ndarray:
    """JPEG bytes → float32 NCHW [n, 3, out, out]."""
    x = np.stack([normalize(resize(decode(j), out), mode) for j in jpegs])
    return np.ascontiguousarray(x.transpose(0, 3, 1, 2), dtype=np.float32)


# ------------------------------------------------------------------ probs


@torch.no_grad()
def probabilities(arch: str, params: dict[str, np.ndarray], jpegs: list[bytes], *,
                  width: float = 1.0, classes: int = 1000, mode: str, device="cpu",
                  precision: str = "float32", block: int = 32) -> np.ndarray:
    """Softmax probabilities [n, classes] (float64) of every photo, in
    blocks of ``block`` photos. Convs and matmuls run in ``precision``
    (TF32 off for float32); the softmax in float64."""
    fn, eps = ARCHS[arch]
    dev = torch.device(device)
    if dev.type == "cuda":
        tf32 = precision == "tf32"
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.benchmark = False
    o = Compute(params, eps, dev, precision)
    out = []
    for i in range(0, len(jpegs), block):
        x = torch.from_numpy(preprocess(jpegs[i : i + block], INPUT_SIZE[arch], mode)).to(dev)
        logits = fn(o, x, width, classes).double()
        out.append(torch.softmax(logits, dim=-1).cpu().numpy())
    return np.concatenate(out)

