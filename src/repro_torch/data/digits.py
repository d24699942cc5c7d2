"""Procedural MNIST-like digit dataset (a copy of ``repro.data.digits``).

The port keeps its own copy so that it imports nothing of ``repro``; the
tests hold both to byte-equal arrays for the same seed.

MNIST itself is not shipped with the repository, so we *simulate* it: 5x7
glyph bitmaps per class, rendered to 28x28 through a random affine warp
(scale/shift/rotate/shear) with stroke jitter, blur and pixel noise. The
result is a 10-class image problem that (a) is learnable from tens of
examples, (b) has enough intra-class variance that uncertainty-driven
acquisition has signal — the two properties the paper's experiments rely on.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# 5x7 glyphs, row-major strings: '#' = ink.
_GLYPHS = {
    0: ["#####",
        "#...#",
        "#...#",
        "#...#",
        "#...#",
        "#...#",
        "#####"],
    1: ["..#..",
        ".##..",
        "..#..",
        "..#..",
        "..#..",
        "..#..",
        ".###."],
    2: ["#####",
        "....#",
        "....#",
        "#####",
        "#....",
        "#....",
        "#####"],
    3: ["#####",
        "....#",
        "....#",
        ".####",
        "....#",
        "....#",
        "#####"],
    4: ["#...#",
        "#...#",
        "#...#",
        "#####",
        "....#",
        "....#",
        "....#"],
    5: ["#####",
        "#....",
        "#....",
        "#####",
        "....#",
        "....#",
        "#####"],
    6: ["#####",
        "#....",
        "#....",
        "#####",
        "#...#",
        "#...#",
        "#####"],
    7: ["#####",
        "....#",
        "...#.",
        "..#..",
        "..#..",
        ".#...",
        ".#..."],
    8: ["#####",
        "#...#",
        "#...#",
        "#####",
        "#...#",
        "#...#",
        "#####"],
    9: ["#####",
        "#...#",
        "#...#",
        "#####",
        "....#",
        "....#",
        "#####"],
}


# Alternative glyph styles per class: structural intra-class diversity so
# that uncertainty correlates with CLASS-BOUNDARY ambiguity (what MNIST has)
# rather than pixel noise — required for acquisition functions to have
# signal (entropy-AL chases label-independent noise otherwise).
_GLYPHS_ALT = {
    1: ["...#.",
        "..##.",
        ".#.#.",
        "...#.",
        "...#.",
        "...#.",
        "...#."],
    2: [".###.",
        "#...#",
        "....#",
        "...#.",
        "..#..",
        ".#...",
        "#####"],
    4: ["...#.",
        "..##.",
        ".#.#.",
        "#..#.",
        "#####",
        "...#.",
        "...#."],
    7: ["#####",
        "....#",
        "...#.",
        "..###",
        "..#..",
        ".#...",
        ".#..."],
    9: [".###.",
        "#...#",
        "#...#",
        ".####",
        "....#",
        "...#.",
        "..#.."],
    3: [".###.",
        "#...#",
        "....#",
        "..##.",
        "....#",
        "#...#",
        ".###."],
    6: ["..##.",
        ".#...",
        "#....",
        "####.",
        "#...#",
        "#...#",
        ".###."],
    0: [".###.",
        "#...#",
        "#..##",
        "#.#.#",
        "##..#",
        "#...#",
        ".###."],
}


def _glyph_array(digit: int, variant: int = 0) -> np.ndarray:
    rows = _GLYPHS_ALT[digit] if (variant and digit in _GLYPHS_ALT) else _GLYPHS[digit]
    return np.array([[1.0 if c == "#" else 0.0 for c in row] for row in rows],
                    dtype=np.float32)  # [7, 5]


def _render(digit: int, rng: np.random.Generator, size: int = 28) -> np.ndarray:
    """Render one digit with a random affine warp + noise. Returns [size, size]."""
    # alternative style is RARE (15%): rare sub-styles are what uncertainty
    # sampling can find and random sampling undersamples (MNIST's rare
    # writer styles play this role)
    glyph = _glyph_array(digit, variant=int(rng.random() < 0.15))
    gh, gw = glyph.shape

    scale = rng.uniform(1.8, 3.6)
    angle = rng.uniform(-0.45, 0.45)          # radians, ~±26°
    shear = rng.uniform(-0.35, 0.35)
    cx = size / 2 + rng.uniform(-4.0, 4.0)
    cy = size / 2 + rng.uniform(-4.0, 4.0)
    thick = rng.uniform(0.35, 0.85)           # stroke radius in glyph cells

    ca, sa = np.cos(angle), np.sin(angle)
    # output pixel (y, x) -> glyph coords via inverse affine
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float32)
    xr = (xs - cx)
    yr = (ys - cy)
    xg = (ca * xr + sa * yr) / scale + shear * yr / scale + (gw - 1) / 2
    yg = (-sa * xr + ca * yr) / scale + (gh - 1) / 2

    # distance-to-ink soft rendering: bilinear sample of the glyph grid
    x0 = np.clip(np.floor(xg).astype(int), 0, gw - 1)
    y0 = np.clip(np.floor(yg).astype(int), 0, gh - 1)
    x1 = np.clip(x0 + 1, 0, gw - 1)
    y1 = np.clip(y0 + 1, 0, gh - 1)
    wx = np.clip(xg - x0, 0.0, 1.0)
    wy = np.clip(yg - y0, 0.0, 1.0)
    inside = (xg > -0.5) & (xg < gw - 0.5) & (yg > -0.5) & (yg < gh - 0.5)
    val = ((1 - wx) * (1 - wy) * glyph[y0, x0] + wx * (1 - wy) * glyph[y0, x1]
           + (1 - wx) * wy * glyph[y1, x0] + wx * wy * glyph[y1, x1])
    img = np.where(inside, val, 0.0).astype(np.float32)
    img = np.clip(img / max(thick, 1e-3), 0.0, 1.0)

    # cheap 3x3 box blur for stroke softness
    k = np.pad(img, 1)
    img = (k[:-2, :-2] + k[:-2, 1:-1] + k[:-2, 2:] + k[1:-1, :-2] + 4 * k[1:-1, 1:-1]
           + k[1:-1, 2:] + k[2:, :-2] + k[2:, 1:-1] + k[2:, 2:]) / 12.0

    # light stroke dropout (class-relevant difficulty comes from the glyph
    # style variants + warps above, NOT from label-independent noise)
    if rng.random() < 0.3:
        eh, ew = rng.integers(3, 6), rng.integers(3, 6)
        ey, ex = rng.integers(0, size - eh), rng.integers(0, size - ew)
        img[ey:ey + eh, ex:ex + ew] *= rng.uniform(0.2, 0.6)

    img = img + rng.normal(0.0, 0.08, img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


@dataclass
class SyntheticDigits:
    """A generated dataset split: images [n, 28, 28, 1] float32, labels [n] int32."""
    images: np.ndarray
    labels: np.ndarray

    def __len__(self):
        return len(self.labels)

    def subset(self, idx) -> "SyntheticDigits":
        return SyntheticDigits(self.images[idx], self.labels[idx])


def make_digit_dataset(n: int, *, seed: int = 0, size: int = 28,
                       class_probs=None) -> SyntheticDigits:
    """Generate ``n`` digit images. ``class_probs`` allows unbalanced splits
    (the paper distributes 'same distribution but unbalanced' data to edges)."""
    rng = np.random.default_rng(seed)
    if n == 0:
        return SyntheticDigits(np.zeros((0, size, size, 1), np.float32),
                               np.zeros((0,), np.int32))
    if class_probs is None:
        labels = rng.integers(0, 10, size=n)
    else:
        p = np.asarray(class_probs, dtype=np.float64)
        p = p / p.sum()
        labels = rng.choice(10, size=n, p=p)
    images = np.stack([_render(int(d), rng, size) for d in labels])
    return SyntheticDigits(images[..., None].astype(np.float32),
                           labels.astype(np.int32))
