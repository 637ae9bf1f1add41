"""The layouts of the Hopper chain (`csrc/mlp_sm90.cuh`) that `mlp_fwd` and
`mlp_bwd` launch, mirrored in Python, and the weight image the wrappers
pre-pack for it.

The kernels' products are `wgmma` operands read from shared memory in the
128-byte-swizzled K-major layout: a row of 64 bf16 lanes is 128 bytes, and
its 16-byte pieces are permuted by XOR with the row's index mod 8.

- `tile_offset(row, col)`: where element (row, col) of a 128-row activation
  or encoding tile sits (in bf16 elements), as the device code's
  `tile_offset` has it (in bytes).
- `fwd_schedule(E)` / `bwd_schedule(E)`: the order in which the kernels read
  64-row chunks of the nine chain matrices (n0w, n1w .. n4w, n5e, n5h, n6w,
  n7w) at an encoding of E = 64 or 128 lanes.
- `pack_chain_image(mw, parts)`: those chunks in that order, each laid out
  as the B operand the kernel reads: a forward chunk (rows k0 .. k0 + 63 of
  W) as the 256 x 64 matrix W[k0 : k0 + 64, :]^T, a backward chunk (rows i0
  .. i0 + 63 of W, read by dh @ W^T) as four 64 x 64 k-atoms of W[i0 : i0 +
  64, :]. The producer warp copies one chunk (32 KB) per stage of its ring
  with a single bulk copy. One gather from a cached index per call.
- `unpack_chain_image`, `chain_from_image`, `dh_chain_from_image`: the
  inverse and plain versions of the chain that read their weights out of the
  image chunk by chunk in the kernel's order and 128-point tiles, zero past
  n, so that the CPU tests pin the layout and the schedule against the JAX
  math.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

TM = 128            # points per tile
NW = 256            # hidden width
KC = 64             # weight rows per chunk; lanes per swizzle row
CHUNK_ELEMS = KC * NW
TILE_ATOM_ELEMS = TM * KC    # one 64-lane atom of a 128-row tile
# the chain's matrices in the C interfaces' order, as indices of the 19-tuple
# of `mlp_fwd.cast_mlp_weights`
CHAIN_MATRIX_IDX = (0, 2, 4, 6, 8, 10, 11, 13, 15)
IMAGE_PARTS = ("fwd", "bwd")


def tile_offset(row, col):
    """Element offset of (row, col) in a swizzled tile of 128 rows (numpy
    arrays or ints): atom col // 64, row, 16-byte piece XOR row % 8."""
    return ((col // KC) * TILE_ATOM_ELEMS + row * KC
            + (((col // 8) % 8) ^ (row % 8)) * 8 + col % 8)


def _matrix_rows(e: int) -> Tuple[int, ...]:
    return tuple(e if m in (0, 5) else NW for m in range(9))


def fwd_schedule(e: int) -> List[Tuple[int, int]]:
    """(matrix, chunk) of every forward chunk in the kernel's order: n0w,
    n1w .. n4w, n5h, n5e, n6w, n7w (n0w and n5e E/64 chunks, the rest 4)."""
    out = [(0, c) for c in range(e // KC)]
    for m in (1, 2, 3, 4):
        out += [(m, c) for c in range(NW // KC)]
    out += [(6, c) for c in range(NW // KC)]
    out += [(5, c) for c in range(e // KC)]
    for m in (7, 8):
        out += [(m, c) for c in range(NW // KC)]
    return out


def bwd_schedule(e: int) -> List[Tuple[int, int]]:
    """(matrix, chunk) of every backward chunk in the kernel's order: the dh
    chain's steps n7w n6w n5e n5h n4w n3w n2w n1w n0w."""
    out = []
    for m in (8, 7, 5, 6, 4, 3, 2, 1, 0):
        out += [(m, c) for c in range((e if m in (0, 5) else NW) // KC)]
    return out


def _fwd_chunk_index(base: int, c: int) -> np.ndarray:
    n = np.arange(NW)[:, None]
    k = np.arange(KC)[None, :]
    pos = n * KC + (((k // 8) ^ (n % 8)) * 8) + k % 8
    out = np.empty(CHUNK_ELEMS, np.int64)
    out[pos.ravel()] = (base + (c * KC + k) * NW + n).ravel()
    return out


def _bwd_chunk_index(base: int, c: int) -> np.ndarray:
    n = np.arange(KC)[:, None]
    k = np.arange(NW)[None, :]
    pos = (k // KC) * (KC * KC) + n * KC + ((((k % KC) // 8) ^ (n % 8)) * 8) \
        + k % 8
    out = np.empty(CHUNK_ELEMS, np.int64)
    out[pos.ravel()] = (base + (c * KC + n) * NW + k).ravel()
    return out


def image_index(e: int, parts: Sequence[str]) -> np.ndarray:
    """For each element of the image, its index in the concatenation of the
    nine flattened chain matrices."""
    bases = np.concatenate([[0], np.cumsum([r * NW for r in _matrix_rows(e)])])
    pieces = []
    for part in parts:
        if part == "fwd":
            pieces += [_fwd_chunk_index(bases[m], c) for m, c in fwd_schedule(e)]
        elif part == "bwd":
            pieces += [_bwd_chunk_index(bases[m], c) for m, c in bwd_schedule(e)]
        else:
            raise ValueError(f"image parts are {IMAGE_PARTS}, got {part!r}")
    return np.concatenate(pieces)


_INDEX: Dict[tuple, torch.Tensor] = {}


def _cached_index(e: int, parts: Tuple[str, ...], device) -> torch.Tensor:
    key = (e, parts, str(device))
    if key not in _INDEX:
        _INDEX[key] = torch.from_numpy(image_index(e, parts)).to(device)
    return _INDEX[key]


def chain_matrices(mw: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """n0w, n1w .. n4w, n5e, n5h, n6w, n7w of the 19 packed weights."""
    return [mw[i] for i in CHAIN_MATRIX_IDX]


def pack_chain_image(mw: Sequence[torch.Tensor],
                     parts: Sequence[str] = ("fwd",)) -> torch.Tensor:
    """The chain's chunks of the cast weights `mw` (bf16 matrices) in the
    kernels' order and layout: the forward's (`("fwd",)`, what `mlp_fwd`
    reads) or the forward's then the backward's (`("fwd", "bwd")`, what
    `mlp_bwd` reads). A flat bf16 tensor of 16,384 elements a chunk."""
    mats = chain_matrices(mw)
    e = mats[0].shape[0]
    flat = torch.cat([m.reshape(-1) for m in mats])
    return flat[_cached_index(e, tuple(parts), flat.device)]


def unpack_chain_image(image: torch.Tensor, e: int,
                       parts: Sequence[str] = ("fwd",)) -> List[torch.Tensor]:
    """The nine chain matrices back from an image (each of its parts holds
    every element of every matrix once)."""
    index = _cached_index(e, tuple(parts), image.device)
    total = sum(r * NW for r in _matrix_rows(e))
    flat = torch.zeros(total, dtype=image.dtype, device=image.device)
    flat[index[:total]] = image[:total]
    out, off = [], 0
    for r in _matrix_rows(e):
        out.append(flat[off:off + r * NW].view(r, NW))
        off += r * NW
    return out


def _unswizzle(rows: torch.Tensor) -> torch.Tensor:
    """(R, 64) rows in the swizzled order back to the logical one."""
    r = rows.shape[0]
    perm = (torch.arange(8)[None, :] ^ (torch.arange(r)[:, None] % 8))
    pieces = rows.reshape(r, 8, 8)
    return torch.gather(pieces, 1, perm[:, :, None].expand(r, 8, 8)).reshape(
        r, KC)


def fwd_chunk_matrix(chunk: torch.Tensor) -> torch.Tensor:
    """A forward chunk of the image as the 64 x 256 weight rows it holds."""
    return _unswizzle(chunk.reshape(NW, KC)).t()


def bwd_chunk_matrix(chunk: torch.Tensor) -> torch.Tensor:
    """A backward chunk of the image as the 64 x 256 weight rows it holds."""
    atoms = [_unswizzle(a.reshape(KC, KC)) for a in chunk.reshape(4, KC * KC)]
    return torch.cat(atoms, dim=1)


def swizzle_tile(x: torch.Tensor) -> torch.Tensor:
    """A (128, C) tile (C a multiple of 64) as the flat shared-memory image
    the kernels keep: `tile_offset` of every element."""
    rows, cols = x.shape
    r = np.arange(rows)[:, None]
    c = np.arange(cols)[None, :]
    out = torch.empty(rows * cols, dtype=x.dtype)
    out[torch.from_numpy(tile_offset(r, c).ravel())] = x.reshape(-1)
    return out


def _mm(a, w):
    return a.float() @ w.float()


def _tiles(x: torch.Tensor, n: int):
    """x (n, C) zero-padded to whole 128-row tiles."""
    n_pad = -(-n // TM) * TM
    return torch.nn.functional.pad(x, (0, 0, 0, n_pad - n))


def chain_from_image(embb: torch.Tensor, image: torch.Tensor,
                     biases: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """nh1 .. nh8 (bf16) of the chain, each tile of 128 points (zero past n)
    read through the image's forward chunks in the kernel's order, chunk by
    chunk summed in f32. biases: n0b .. n4b, n5b, n6b, n7b. Rows past n are
    dropped."""
    n, e = embb.shape
    x = _tiles(embb.to(torch.bfloat16), n)
    chunks = iter(fwd_chunk_matrix(c) for c in
                  image[:len(fwd_schedule(e)) * CHUNK_ELEMS].view(-1, CHUNK_ELEMS))
    nh, act = [], None
    for layer in range(8):
        if layer == 0:
            srcs = [(x, c) for c in range(e // KC)]
        elif layer == 5:
            srcs = [(act, c) for c in range(NW // KC)] + \
                [(x, c) for c in range(e // KC)]
        else:
            srcs = [(act, c) for c in range(NW // KC)]
        acc = torch.zeros(x.shape[0], NW)
        for a, c in srcs:
            acc = acc + _mm(a[:, c * KC:(c + 1) * KC], next(chunks))
        act = torch.relu(acc + biases[layer].reshape(1, NW).float()).to(
            torch.bfloat16)
        nh.append(act)
    return [h[:n] for h in nh]


def dh_chain_from_image(nh: Sequence[torch.Tensor], dh8: torch.Tensor,
                        image: torch.Tensor, e: int
                        ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """demb (n, E) f32 and [dh1 .. dh8] (bf16) of the backward's dh chain from
    dh8, read through the image's backward chunks in the kernel's order: each
    chunk gives 64 output columns, masked by the ReLU gate of nh_l."""
    n = dh8.shape[0]
    first = len(fwd_schedule(e)) * CHUNK_ELEMS
    chunks = iter(bwd_chunk_matrix(c) for c in
                  image[first:].view(-1, CHUNK_ELEMS))
    cur = dh8.to(torch.bfloat16)
    dh = [cur]
    demb = torch.zeros(n, e)
    for layer in (7, 6, 0, 5, 4, 3, 2, 1, 0):
        cols = NW if layer else e
        out = torch.cat([cur.float() @ next(chunks).float().t()
                         for _ in range(cols // KC)], dim=1)
        if layer:
            cur = (out * (nh[layer - 1].float() > 0)).to(torch.bfloat16)
            dh.insert(0, cur)
        else:
            demb = demb + out
    return demb, dh
