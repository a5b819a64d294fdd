"""Fixed-shape frame tiles for the feature and all-pdf emission products.

On the card a float32 GEMM, FFT or reduction picks its kernel and its
split of the work from the shape it is given, so the same row rounds one
way in a batch of 32 and another alone, and an alignment's score would
move with ``--batch_size`` or the rank count. The functions of the
feature layer (MFCC, the LDA and fMLLR transforms, all-pdf emissions) run
their products through :func:`map_row_blocks` instead: each row's frames
are cut into blocks of ``BLOCK`` frames counted from its first frame, and
the blocks go through the op ``tile_frames // BLOCK`` at a time, every
call at the same shape, the last one filled with copies of real frames
whose results are dropped. So a frame's inputs, its place within its
block and the shape of every call are the same at any batch size.
"""

from __future__ import annotations

from typing import Callable

import torch

# frames of a block, all of one row (the fMLLR product's unit: one speaker
# matrix a block); each function's tile is a multiple of it
BLOCK = 16
# the most frames of a tile on the CPU: the card's tiles (up to 8,192
# frames, sized for few launches) would make a short call compute
# thousands of frames it drops, and much smaller ones multiply the small
# parallel regions of the CPU's ops
CPU_TILE_FRAMES = 2048


def map_row_blocks(
    fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    tile_frames: int,
) -> torch.Tensor:
    """``fn`` over the frame blocks of ``x`` (R, T, *rest), a fixed number
    of blocks a call.

    ``fn(blocks, rows)`` gets (NB, BLOCK, *rest) frames, NB =
    ``max(1, tile_frames // BLOCK)`` (``tile_frames`` capped at
    ``CPU_TILE_FRAMES`` on the CPU), and the (NB,) int64 row of each
    block, and returns (NB, BLOCK, *out) with each frame's result in its
    place. Returns (R, T, *out), contiguous: frame t of row r from the
    call that held it. ``x`` may be a strided view (the MFCC's framed
    waves): each call gathers its own frames."""
    R, T = x.shape[:2]
    dev = x.device
    if dev.type == "cpu":
        tile_frames = min(tile_frames, CPU_TILE_FRAMES)
    nb_tile = max(1, tile_frames // BLOCK)
    if R * T == 0:  # no frames: fn on no blocks gives the output's type
        out = fn(x.new_zeros((0, BLOCK) + tuple(x.shape[2:])),
                 torch.zeros(0, dtype=torch.int64, device=dev))
        return out.new_empty((R, T) + tuple(out.shape[2:]))
    per_row = -(-T // BLOCK)
    n_tiles = -(-(R * per_row) // nb_tile)
    blk = torch.arange(n_tiles * nb_tile, device=dev)
    rows = torch.clamp(blk // per_row, max=R - 1)
    t = (blk % per_row * BLOCK)[:, None] + torch.arange(BLOCK, device=dev)
    t = torch.clamp(t, max=T - 1)
    out = None
    for k in range(n_tiles):
        s = slice(k * nb_tile, (k + 1) * nb_tile)
        part = fn(x[rows[s, None], t[s]], rows[s])
        if out is None:
            out = part.new_empty((n_tiles * nb_tile,) + tuple(part.shape[1:]))
        out[s] = part
    out = out[: R * per_row].reshape((R, per_row * BLOCK) + tuple(out.shape[2:]))
    return out[:, :T].contiguous()
