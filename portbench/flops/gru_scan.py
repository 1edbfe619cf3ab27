"""The GRU time scan's kernels (forward, and backward with its dW_hh
contraction): each step of each direction and layer multiplies the
``[B, H]`` state by ``W_hh [H, 3H]``; the backward does that product's two
transposes (dh and dW_hh)."""


def forward_ops(b: int, h: int, frames: int, dirs: int) -> float:
    """One layer's forward: ``2 B H 3H`` a step, direction."""
    return 2.0 * b * h * 3 * h * frames * dirs


def backward_ops(b: int, h: int, frames: int, dirs: int) -> float:
    return 2.0 * forward_ops(b, h, frames, dirs)


def forward_bytes(b: int, h: int, frames: int, dirs: int, train: bool) -> float:
    """float32: xp in, W_hh and b_hh in, ys out (and the gates kept for the
    backward in training)."""
    n = frames * dirs * b * 3 * h + dirs * h * 3 * h + dirs * 3 * h + frames * dirs * b * h
    if train:
        n += frames * dirs * b * 4 * h
    return 4.0 * n


def backward_bytes(b: int, h: int, frames: int, dirs: int) -> float:
    """float32: the gates, ys and dys in, W_hh in, dxp, dW_hh and db_hh out."""
    n = (frames * dirs * b * 4 * h + 2 * frames * dirs * b * h + dirs * h * 3 * h
         + frames * dirs * b * 3 * h + dirs * h * 3 * h + dirs * 3 * h)
    return 4.0 * n
