"""Pixel-to-grid-cell index arithmetic.

Free functions over (batched) integer tensors: the cell grid that covers an
image at a cell size, and the cell a pixel falls in.
"""
from __future__ import annotations

import torch

__all__ = ["grid_dims", "cell_x", "cell_y", "cell_xy"]


def grid_dims(width: int, height: int, cell_size: int):
    """(columns, rows) of the cell grid covering a width x height image
    (ceil division)."""
    return -(-width // cell_size), -(-height // cell_size)


def _cell(v, cell_size):
    # Truncation to int32 first, then floor division, as the reference does.
    return torch.div(
        torch.as_tensor(v).to(torch.int32), cell_size, rounding_mode="floor"
    )


def cell_x(x, cell_size):
    return _cell(x, cell_size)


def cell_y(y, cell_size):
    return _cell(y, cell_size)


def cell_xy(x, y, columns, cell_size):
    """Flat cell index: (y // s) * columns + x // s."""
    return cell_y(y, cell_size) * columns + cell_x(x, cell_size)
