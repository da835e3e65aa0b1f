"""MNIST data layer: real IDX files when available, procedural fallback.

numpy copy of ``repro.data.synthetic_mnist``: for the same arguments it
gives arrays equal to the reference's.  Nothing is downloaded.
``load_mnist`` reads the IDX files from ``data/mnist/`` at the
repository root; if they are absent it generates a deterministic
procedural handwritten-digit dataset (vector strokes per digit class +
random affine jitter + blur + noise) whose
statistics are MNIST-like (28x28 grayscale in [0,1], 10 classes).  The
paper's validation target — accuracy deltas across the 32 MAC configs —
is dataset-instance independent, and the loader makes
the reproduction exact when real MNIST is present.

Feature reduction (paper: 784 -> 62 inputs "for a more hardware-efficient
design"; the algorithm is not specified): we use 4x4 average pooling of
the 24x24 center crop (-> 36) plus 26 fixed random-projection features,
i.e. 62 deterministic linear features — reproducible in hardware as fixed
wiring, matching the paper's constraint that reduction happens before
the network.
"""
from __future__ import annotations

import gzip
import os
import struct
from dataclasses import dataclass

import numpy as np

N_FEATURES = 62
_MNIST_DIRS = (os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir,
    os.pardir, "data", "mnist")),)


# ---------------------------------------------------------------------------
# real MNIST (IDX format)
# ---------------------------------------------------------------------------

def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, = struct.unpack(">I", f.read(4))
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)


def _try_load_real() -> tuple | None:
    names = {
        "train_x": ("train-images-idx3-ubyte", "train-images.idx3-ubyte"),
        "train_y": ("train-labels-idx1-ubyte", "train-labels.idx1-ubyte"),
        "test_x": ("t10k-images-idx3-ubyte", "t10k-images.idx3-ubyte"),
        "test_y": ("t10k-labels-idx1-ubyte", "t10k-labels.idx1-ubyte"),
    }
    for d in _MNIST_DIRS:
        if not os.path.isdir(d):
            continue
        found = {}
        for key, cands in names.items():
            for c in cands:
                for suffix in ("", ".gz"):
                    p = os.path.join(d, c + suffix)
                    if os.path.exists(p):
                        found[key] = p
                        break
                if key in found:
                    break
        if len(found) == 4:
            tx = _read_idx(found["train_x"]).astype(np.float32) / 255.0
            ty = _read_idx(found["train_y"]).astype(np.int32)
            vx = _read_idx(found["test_x"]).astype(np.float32) / 255.0
            vy = _read_idx(found["test_y"]).astype(np.int32)
            return tx, ty, vx, vy
    return None


# ---------------------------------------------------------------------------
# procedural fallback
# ---------------------------------------------------------------------------

# stroke skeletons per digit on a 20x20 canvas: list of polylines
_DIGIT_STROKES: dict[int, list] = {
    0: [[(6, 4), (13, 4), (16, 8), (16, 13), (13, 17), (6, 17), (3, 13), (3, 8), (6, 4)]],
    1: [[(9, 3), (11, 3), (11, 17)], [(7, 17), (15, 17)]],
    2: [[(4, 6), (7, 3), (13, 3), (16, 6), (15, 10), (4, 17), (16, 17)]],
    3: [[(4, 4), (14, 4), (10, 9), (15, 12), (14, 16), (4, 17)]],
    4: [[(12, 3), (4, 12), (16, 12)], [(12, 3), (12, 17)]],
    5: [[(15, 3), (5, 3), (5, 9), (13, 9), (16, 13), (12, 17), (4, 16)]],
    6: [[(13, 3), (6, 7), (4, 12), (7, 17), (13, 16), (15, 12), (10, 10), (5, 12)]],
    7: [[(4, 3), (16, 3), (9, 17)]],
    8: [[(10, 3), (5, 6), (10, 10), (15, 6), (10, 3)],
        [(10, 10), (4, 14), (10, 17), (16, 14), (10, 10)]],
    9: [[(15, 8), (10, 10), (5, 7), (9, 3), (14, 4), (15, 8), (13, 17), (7, 17)]],
}


def _render_digit(digit: int, rng: np.random.Generator) -> np.ndarray:
    canvas = np.zeros((28, 28), dtype=np.float32)
    # random affine: scale, rotation, shear, translation
    ang = rng.normal(0.0, 0.15)
    scale = rng.normal(1.0, 0.08, size=2).clip(0.8, 1.2)
    shear = rng.normal(0.0, 0.1)
    tx, ty = rng.normal(4.0, 1.2), rng.normal(4.0, 1.2)
    ca, sa = np.cos(ang), np.sin(ang)
    m = np.array([[ca * scale[0], -sa + shear], [sa, ca * scale[1]]])
    thick = rng.uniform(0.7, 1.3)
    for stroke in _DIGIT_STROKES[digit]:
        pts = np.array(stroke, dtype=np.float32)
        pts = pts @ m.T + np.array([tx, ty])
        for (x0, y0), (x1, y1) in zip(pts[:-1], pts[1:]):
            n = max(int(np.hypot(x1 - x0, y1 - y0) * 3), 2)
            xs = np.linspace(x0, x1, n) + rng.normal(0, 0.12, n)
            ys = np.linspace(y0, y1, n) + rng.normal(0, 0.12, n)
            for x, y in zip(xs, ys):
                xi, yi = int(round(x)), int(round(y))
                for dx in (-1, 0, 1):
                    for dy in (-1, 0, 1):
                        px, py = xi + dx, yi + dy
                        if 0 <= px < 28 and 0 <= py < 28:
                            d = np.hypot(x - px, y - py)
                            canvas[py, px] = max(canvas[py, px],
                                                 float(np.exp(-(d / thick) ** 2)))
    noise = rng.normal(0, 0.02, canvas.shape).astype(np.float32)
    return np.clip(canvas + noise, 0.0, 1.0)


def _generate_procedural(n_train: int, n_test: int, seed: int):
    rng = np.random.default_rng(seed)
    def gen(n, r):
        ys = r.integers(0, 10, size=n).astype(np.int32)
        xs = np.stack([_render_digit(int(y), r) for y in ys])
        return xs, ys
    tx, ty = gen(n_train, rng)
    vx, vy = gen(n_test, np.random.default_rng(seed + 1))
    return tx, ty, vx, vy


# ---------------------------------------------------------------------------
# feature reduction: 784 -> 62
# ---------------------------------------------------------------------------

def _projection_matrix(seed: int = 1234) -> np.ndarray:
    """26 fixed random-projection rows over the 784 pixels (unit norm)."""
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(26, 784)).astype(np.float32)
    return m / np.linalg.norm(m, axis=1, keepdims=True)


_PROJ = _projection_matrix()


def reduce_features(images: np.ndarray) -> np.ndarray:
    """(N, 28, 28) or (N, 784) -> (N, 62) in [0, ~1]."""
    imgs = images.reshape(len(images), 28, 28)
    crop = imgs[:, 2:26, 2:26]                                    # 24x24
    pooled = crop.reshape(len(imgs), 6, 4, 6, 4).mean(axis=(2, 4))  # 6x6=36
    proj = images.reshape(len(images), 784) @ _PROJ.T * 0.1        # 26
    feats = np.concatenate([pooled.reshape(len(imgs), 36), proj], axis=1)
    return feats.astype(np.float32)


@dataclass
class MNISTData:
    train_x: np.ndarray   # (N, 62)
    train_y: np.ndarray
    test_x: np.ndarray
    test_y: np.ndarray
    source: str           # "real" | "procedural"


def load_mnist(n_train: int = 8000, n_test: int = 2000,
               seed: int = 0) -> MNISTData:
    real = _try_load_real()
    if real is not None:
        tx, ty, vx, vy = real
        src = "real"
    else:
        tx, ty, vx, vy = _generate_procedural(n_train, n_test, seed)
        src = "procedural"
    tx, ty = tx[:n_train], ty[:n_train]
    vx, vy = vx[:n_test], vy[:n_test]
    return MNISTData(train_x=reduce_features(tx), train_y=ty,
                     test_x=reduce_features(vx), test_y=vy, source=src)
