"""The two classifiers' architectures, written once as functions over an
``ops`` object, and the shape walk over them.

:class:`Shapes` follows (channels, height, width) through the layers and
records every parameter's shape under the flat key the program's serving
export uses (``params/<layer>/conv/kernel`` HWIO, ``params/<layer>/bn/
{scale,bias}``, ``batch_stats/<layer>/bn/{mean,var}``, ``params/logits/
{kernel,bias}``) and the multiply-adds of every conv and of the dense head.
``reference.Compute`` runs the same functions on tensors.

Inception-v3 follows Szegedy et al. 2016 (arXiv:1512.00567) as the Keras
and TF-slim models lay it out: 3×3 stride-1 average pools that count the
padding, VALID max pools, BN ε 1e-3. ResNet-50 is He et al. 2016
(arXiv:1512.03385) in the v1.5 form (stride 2 on each bottleneck's 3×3),
BN ε 1e-5, a "SAME" 3×3 stride-2 max pool padded with −inf. Pure Python:
the harness walks shapes before it imports torch.
"""

from __future__ import annotations

INPUT_SIZE = {"inception_v3": 299, "resnet50": 224}


def scale_ch(c: int, width: float, divisor: int = 8) -> int:
    """Channels at a width multiplier, rounded to a multiple of 8 and never
    more than 10% below ``c * width`` (the MobileNet rounding rule)."""
    v = max(divisor, int(c * width + divisor / 2) // divisor * divisor)
    if v < 0.9 * c * width:
        v += divisor
    return v


def same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """TensorFlow's "SAME" padding of one axis: (before, after)."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def out_dim(size: int, k: int, s: int, padding: str) -> int:
    return -(-size // s) if padding == "SAME" else (size - k) // s + 1


class Shapes:
    """Shape mode: ``x`` is (c, h, w); records parameter shapes and MACs."""

    def __init__(self):
        self.params: dict[str, tuple[int, ...]] = {}
        self.macs = 0

    def conv(self, x, name, cout, k=(1, 1), stride=1, padding="SAME", act="relu"):
        c, h, w = x
        oh, ow = out_dim(h, k[0], stride, padding), out_dim(w, k[1], stride, padding)
        self.params[f"params/{name}/conv/kernel"] = (k[0], k[1], c, cout)
        for leaf in ("scale", "bias"):
            self.params[f"params/{name}/bn/{leaf}"] = (cout,)
        for leaf in ("mean", "var"):
            self.params[f"batch_stats/{name}/bn/{leaf}"] = (cout,)
        self.macs += oh * ow * cout * k[0] * k[1] * c
        return cout, oh, ow

    def max_pool(self, x, padding="VALID"):
        c, h, w = x
        return c, out_dim(h, 3, 2, padding), out_dim(w, 3, 2, padding)

    def avg_pool(self, x):
        return x

    def cat(self, xs):
        return sum(x[0] for x in xs), xs[0][1], xs[0][2]

    def add_relu(self, a, b):
        return a

    def head(self, x, classes):
        self.params["params/logits/kernel"] = (x[0], classes)
        self.params["params/logits/bias"] = (classes,)
        self.macs += x[0] * classes
        return classes


def inception_v3(o, x, width: float, classes: int):
    w = lambda c: scale_ch(c, width)  # noqa: E731

    def block_a(x, n, pool_features):
        b1 = o.conv(x, f"{n}/b1x1", w(64))
        b5 = o.conv(o.conv(x, f"{n}/b5x5_1", w(48)), f"{n}/b5x5_2", w(64), (5, 5))
        b3 = o.conv(x, f"{n}/b3x3dbl_1", w(64))
        b3 = o.conv(o.conv(b3, f"{n}/b3x3dbl_2", w(96), (3, 3)), f"{n}/b3x3dbl_3", w(96), (3, 3))
        bp = o.conv(o.avg_pool(x), f"{n}/bpool", w(pool_features))
        return o.cat([b1, b5, b3, bp])

    def reduction_a(x, n):
        b3 = o.conv(x, f"{n}/b3x3", w(384), (3, 3), 2, "VALID")
        bd = o.conv(x, f"{n}/b3x3dbl_1", w(64))
        bd = o.conv(bd, f"{n}/b3x3dbl_2", w(96), (3, 3))
        bd = o.conv(bd, f"{n}/b3x3dbl_3", w(96), (3, 3), 2, "VALID")
        return o.cat([b3, bd, o.max_pool(x)])

    def block_b(x, n, c7):
        c7 = w(c7)
        b1 = o.conv(x, f"{n}/b1x1", w(192))
        b7 = o.conv(x, f"{n}/b7x7_1", c7)
        b7 = o.conv(o.conv(b7, f"{n}/b7x7_2", c7, (1, 7)), f"{n}/b7x7_3", w(192), (7, 1))
        bd = o.conv(x, f"{n}/b7x7dbl_1", c7)
        for i, (k, c) in enumerate([((7, 1), c7), ((1, 7), c7), ((7, 1), c7), ((1, 7), w(192))]):
            bd = o.conv(bd, f"{n}/b7x7dbl_{i + 2}", c, k)
        bp = o.conv(o.avg_pool(x), f"{n}/bpool", w(192))
        return o.cat([b1, b7, bd, bp])

    def reduction_b(x, n):
        b3 = o.conv(o.conv(x, f"{n}/b3x3_1", w(192)), f"{n}/b3x3_2", w(320), (3, 3), 2, "VALID")
        b7 = o.conv(x, f"{n}/b7x7x3_1", w(192))
        b7 = o.conv(b7, f"{n}/b7x7x3_2", w(192), (1, 7))
        b7 = o.conv(b7, f"{n}/b7x7x3_3", w(192), (7, 1))
        b7 = o.conv(b7, f"{n}/b7x7x3_4", w(192), (3, 3), 2, "VALID")
        return o.cat([b3, b7, o.max_pool(x)])

    def block_c(x, n):
        b1 = o.conv(x, f"{n}/b1x1", w(320))
        b3 = o.conv(x, f"{n}/b3x3_1", w(384))
        bd = o.conv(o.conv(x, f"{n}/b3x3dbl_1", w(448)), f"{n}/b3x3dbl_2", w(384), (3, 3))
        bp = o.conv(o.avg_pool(x), f"{n}/bpool", w(192))
        return o.cat([b1, o.conv(b3, f"{n}/b3x3_2a", w(384), (1, 3)),
                      o.conv(b3, f"{n}/b3x3_2b", w(384), (3, 1)),
                      o.conv(bd, f"{n}/b3x3dbl_3a", w(384), (1, 3)),
                      o.conv(bd, f"{n}/b3x3dbl_3b", w(384), (3, 1)), bp])

    x = o.conv(x, "stem1", w(32), (3, 3), 2, "VALID")
    x = o.conv(x, "stem2", w(32), (3, 3), 1, "VALID")
    x = o.max_pool(o.conv(x, "stem3", w(64), (3, 3)))
    x = o.conv(x, "stem4", w(80), (1, 1), 1, "VALID")
    x = o.max_pool(o.conv(x, "stem5", w(192), (3, 3), 1, "VALID"))
    x = block_a(x, "mixed5b", 32)
    x = block_a(x, "mixed5c", 64)
    x = block_a(x, "mixed5d", 64)
    x = reduction_a(x, "mixed6a")
    for n, c7 in (("mixed6b", 128), ("mixed6c", 160), ("mixed6d", 160), ("mixed6e", 192)):
        x = block_b(x, n, c7)
    x = reduction_b(x, "mixed7a")
    x = block_c(block_c(x, "mixed7b"), "mixed7c")
    return o.head(x, classes)


def resnet50(o, x, width: float, classes: int):
    w = lambda c: scale_ch(c, width)  # noqa: E731
    x = o.max_pool(o.conv(x, "stem", w(64), (7, 7), 2), "SAME")
    c = w(64)
    for i, (ch, blocks, stride) in enumerate([(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)]):
        for j in range(blocks):
            n, s, out = f"stage{i}_{j}", stride if j == 0 else 1, w(ch) * 4
            short = (o.conv(x, f"{n}/downsample", out, (1, 1), s, act=None)
                     if c != out or s != 1 else x)
            y = o.conv(o.conv(x, f"{n}/conv1", w(ch)), f"{n}/conv2", w(ch), (3, 3), s)
            x = o.add_relu(o.conv(y, f"{n}/conv3", out, act=None), short)
            c = out
    return o.head(x, classes)


ARCHS = {"inception_v3": (inception_v3, 1e-3), "resnet50": (resnet50, 1e-5)}


def walk_shapes(arch: str, width: float = 1.0, classes: int = 1000) -> Shapes:
    """The architecture's parameter shapes and MACs for one image."""
    fn, _ = ARCHS[arch]
    s = INPUT_SIZE[arch]
    o = Shapes()
    fn(o, (3, s, s), width, classes)
    return o
