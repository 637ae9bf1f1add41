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
- `views_schedule`, `pack_views_image`, `unpack_views_image`,
  `views_bwd_from_image`: the same for `mlpv_bwd`'s image (the chain and the
  view-direction heads fw, vwf, vwv; 78 chunks, the view layer's 8 or 16 KB
  of their 32 KB slots, `views_chunk_bytes`).
- `encode_tile`, `fold_tile`: `mlpe_bwd`'s in-kernel encoding, written into
  the swizzled tile by the threads that own its rows, and its fold of demb
  onto the points in the order the threads sum.
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
VEMB = 32           # view-encoding lanes
VW = 128            # width of the view-conditioned layer
# the view-direction image's matrices: the chain's nine, then fw, vwf and
# vwv, as indices of the 26-tuple of `mlpv_fwd.cast_mlpv_weights`
VIEWS_MATRIX_IDX = CHAIN_MATRIX_IDX + (17, 21, 22)
FW, VWF, VWV = 9, 10, 11


def tile_offset(row, col):
    """Element offset of (row, col) in a swizzled tile of 128 rows (numpy
    arrays or ints): atom col // 64, row, 16-byte piece XOR row % 8."""
    return ((col // KC) * TILE_ATOM_ELEMS + row * KC
            + (((col // 8) % 8) ^ (row % 8)) * 8 + col % 8)


def _matrix_rows(e: int) -> Tuple[int, ...]:
    return tuple(e if m in (0, 5) else NW for m in range(9))


def _matrix_shapes(e: int, views: bool = False) -> List[Tuple[int, int]]:
    shapes = [(r, NW) for r in _matrix_rows(e)]
    return shapes + [(NW, NW), (NW, VW), (VEMB, VW)] if views else shapes


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


def views_schedule() -> List[Tuple[str, int, int]]:
    """(layout, matrix, chunk) of every chunk of `mlpv_bwd`'s image in the
    kernel's order (matrices as in `VIEWS_MATRIX_IDX`'s order): the chain's
    forward chunks; fw (4), vwf (4), vwv (1) in the forward layout; vwf (4),
    vwv (1), fw (4) as the B operands of dhv @ vwf^T, dhv @ vwv^T and dfeat @
    fw^T; the chain's backward chunks."""
    out = [("fwd", m, c) for m, c in fwd_schedule(64)]
    out += [("fwd", FW, c) for c in range(NW // KC)]
    out += [("fwd", VWF, c) for c in range(NW // KC)] + [("fwd", VWV, 0)]
    out += [("bwd", VWF, c) for c in range(NW // KC)] + [("bwd", VWV, 0)]
    out += [("bwd", FW, c) for c in range(NW // KC)]
    return out + [("bwd", m, c) for m, c in bwd_schedule(64)]


def _chunk_elems(layout: str, shape: Tuple[int, int]) -> int:
    rows, cols = shape
    return cols * KC if layout == "fwd" else min(KC, rows) * cols


def views_chunk_bytes() -> List[int]:
    """The bytes of each chunk of the view-direction image that the kernel's
    producer copies (the rest of its 32 KB slot is zero)."""
    shapes = _matrix_shapes(64, views=True)
    return [2 * _chunk_elems(layout, shapes[m])
            for layout, m, _ in views_schedule()]


def _chunk_index(layout: str, base: int, shape: Tuple[int, int],
                 c: int) -> np.ndarray:
    """For each element of one 32 KB chunk slot, its index in the
    concatenated matrices, or -1 (zero). A forward chunk of W (rows x cols)
    holds W[64c : 64c + 64, :]^T: cols rows of 64 k-lanes, zero past W's
    rows. A backward chunk holds W[r0 : r0 + nr, :] (nr = min(64, rows), r0
    = nr * c) as cols / 64 k-atoms of nr rows."""
    rows, cols = shape
    out = np.full(CHUNK_ELEMS, -1, np.int64)
    if layout == "fwd":
        n = np.arange(cols)[:, None]
        k = np.arange(KC)[None, :]
        pos = n * KC + (((k // 8) ^ (n % 8)) * 8) + k % 8
        src = np.where(c * KC + k < rows, base + (c * KC + k) * cols + n, -1)
    else:
        nr = min(KC, rows)
        n = np.arange(nr)[:, None]
        k = np.arange(cols)[None, :]
        pos = (k // KC) * (nr * KC) + n * KC + ((((k % KC) // 8) ^ (n % 8)) * 8) \
            + k % 8
        src = base + (c * nr + n) * cols + k
    out[pos.ravel()] = np.broadcast_to(src, pos.shape).ravel()
    return out


def _bases(shapes) -> np.ndarray:
    return np.concatenate([[0], np.cumsum([r * c for r, c in shapes])])


def image_index(e: int, parts: Sequence[str]) -> np.ndarray:
    """For each element of the image, its index in the concatenation of the
    nine flattened chain matrices."""
    shapes = _matrix_shapes(e)
    bases = _bases(shapes)
    pieces = []
    for part in parts:
        if part == "fwd":
            pieces += [_chunk_index("fwd", bases[m], shapes[m], c)
                       for m, c in fwd_schedule(e)]
        elif part == "bwd":
            pieces += [_chunk_index("bwd", bases[m], shapes[m], c)
                       for m, c in bwd_schedule(e)]
        else:
            raise ValueError(f"image parts are {IMAGE_PARTS}, got {part!r}")
    return np.concatenate(pieces)


def views_index() -> np.ndarray:
    """For each element of the view-direction image, its index in the
    concatenation of its twelve flattened matrices, or -1 (zero)."""
    shapes = _matrix_shapes(64, views=True)
    bases = _bases(shapes)
    return np.concatenate([_chunk_index(layout, bases[m], shapes[m], c)
                           for layout, m, c in views_schedule()])


_INDEX: Dict[tuple, torch.Tensor] = {}


def _cached_index(e: int, parts: Tuple[str, ...], device) -> torch.Tensor:
    """The image's index, -1 replaced by the position of a zero appended to
    the concatenated matrices."""
    key = (e, parts, str(device))
    if key not in _INDEX:
        if parts == ("views",):
            index, total = views_index(), _bases(_matrix_shapes(e, True))[-1]
        else:
            index, total = image_index(e, parts), _bases(_matrix_shapes(e))[-1]
        _INDEX[key] = torch.from_numpy(np.where(index < 0, total, index)).to(
            device)
    return _INDEX[key]


def _gather(mats: Sequence[torch.Tensor], index: torch.Tensor) -> torch.Tensor:
    flat = torch.cat([m.reshape(-1) for m in mats] + [mats[0].new_zeros(1)])
    return flat[index]


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
    return _gather(mats, _cached_index(mats[0].shape[0], tuple(parts),
                                       mats[0].device))


def pack_views_image(mw: Sequence[torch.Tensor]) -> torch.Tensor:
    """The chunks of `mlpv_bwd`'s image from its 26 cast weights, in the
    kernel's order (`views_schedule`), 16,384 bf16 elements a chunk."""
    mats = [mw[i] for i in VIEWS_MATRIX_IDX]
    return _gather(mats, _cached_index(64, ("views",), mats[0].device))


def unpack_views_image(image: torch.Tensor) -> List[torch.Tensor]:
    """The twelve matrices back from a view-direction image."""
    shapes = _matrix_shapes(64, views=True)
    index = _cached_index(64, ("views",), image.device)
    total = int(_bases(shapes)[-1])
    flat = torch.zeros(total + 1, dtype=image.dtype, device=image.device)
    flat[index] = image
    out, off = [], 0
    for r, c in shapes:
        out.append(flat[off:off + r * c].view(r, c))
        off += r * c
    return out


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


def fwd_chunk_matrix(chunk: torch.Tensor, cols: int = NW) -> torch.Tensor:
    """A forward chunk of the image as the 64 x cols weight rows it holds
    (rows past the matrix's end are zero)."""
    return _unswizzle(chunk[:cols * KC].reshape(cols, KC)).t()


def bwd_chunk_matrix(chunk: torch.Tensor, rows: int = KC,
                     cols: int = NW) -> torch.Tensor:
    """A backward chunk of the image as the rows x cols weight rows it
    holds."""
    atoms = [_unswizzle(a.reshape(rows, KC))
             for a in chunk[:rows * cols].reshape(cols // KC, rows * KC)]
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
                        image: torch.Tensor, e: int, first: int = None
                        ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """demb (n, E) f32 and [dh1 .. dh8] (bf16) of the backward's dh chain from
    dh8, read through the image's backward chunks in the kernel's order: each
    chunk gives 64 output columns, masked by the ReLU gate of nh_l. `first`:
    the index of the chain's first backward chunk (after the forward's)."""
    n = dh8.shape[0]
    first = (len(fwd_schedule(e)) if first is None else first) * CHUNK_ELEMS
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


# biases of the 26 cast view-direction weights: n0b .. n4b, n5b, n6b, n7b
_CHAIN_BIASES = (1, 3, 5, 7, 9, 12, 14, 16)


def _mask(g, act):
    return (g * (act.float() > 0)).to(torch.bfloat16)


def _tn(act, g):
    return act.float().t() @ g.float()


def views_bwd_from_image(embb: torch.Tensor, embvb: torch.Tensor,
                         image: torch.Tensor, mw: Sequence[torch.Tensor],
                         draw: torch.Tensor):
    """demb (n, 64), dembv (n, 32) f32 and the 26 gradients of `mlpv_bwd`,
    reading the chain's and the heads' matrices out of the image chunk by
    chunk in the kernel's order (`views_schedule`), on 128-point tiles with
    rows past n zero, each chunk's product summed in f32: the recompute,
    feat, hv, dhv, dfeat, dembv, dh8 (the alpha term added to fw's
    products), the dh chain, then the dW products of the scratch and the
    heads' sums. The biases, aw and rw come from mw (the 26 cast weights),
    the rest from the image."""
    bf16 = torch.bfloat16
    n = embb.shape[0]
    sched = views_schedule()
    slots = image.view(-1, CHUNK_ELEMS)
    shapes = _matrix_shapes(64, views=True)

    def chunk(layout, m, c):
        slot = slots[sched.index((layout, m, c))]
        if layout == "fwd":
            return fwd_chunk_matrix(slot, shapes[m][1])
        return bwd_chunk_matrix(slot, min(KC, shapes[m][0]), shapes[m][1])

    fb, aw, vb, rw = mw[18], mw[19], mw[23], mw[24]
    nh = [_tiles(h, n) for h in
          chain_from_image(embb, image, [mw[i] for i in _CHAIN_BIASES])]
    ev = _tiles(embvb.to(bf16), n)
    drawb = _tiles(draw.to(bf16), n)
    acc = 0.0
    for c in range(NW // KC):
        acc = acc + _mm(nh[7][:, c * KC:(c + 1) * KC], chunk("fwd", FW, c))
    feat = (acc + fb.float()).to(bf16)
    acc = 0.0
    for c in range(NW // KC):
        acc = acc + _mm(feat[:, c * KC:(c + 1) * KC], chunk("fwd", VWF, c))
    acc = acc + _mm(ev, chunk("fwd", VWV, 0)[:VEMB])
    hv = torch.relu(acc + vb.float()).to(bf16)
    dhv = _mask(drawb.float() @ rw.float().t(), hv)
    dfeat = torch.cat([dhv.float() @ chunk("bwd", VWF, c).float().t()
                       for c in range(NW // KC)], dim=1).to(bf16)
    dembv = dhv.float() @ chunk("bwd", VWV, 0).float().t()
    dh8 = _mask(torch.cat([dfeat.float() @ chunk("bwd", FW, c).float().t()
                           for c in range(NW // KC)], dim=1)
                + drawb.float() @ aw.float().t(), nh[7])
    demb, dh = dh_chain_from_image(nh, dh8, image, 64,
                                   first=sched.index(("bwd", 8, 0)))
    # the second pass over the scratch (rows past n are zero in every dh)
    x = _tiles(embb.to(bf16), n)
    acts = [x] + nh[:7]
    grads = []
    for l in range(8):
        if l == 5:
            grads += [_tn(x, dh[5]), _tn(nh[4], dh[5]),
                      dh[5].float().sum(0, keepdim=True)]
        else:
            grads += [_tn(acts[l], dh[l]), dh[l].float().sum(0, keepdim=True)]
    sum_draw = draw.float().sum(0, keepdim=True)
    grads += [_tn(nh[7], dfeat), dfeat.float().sum(0, keepdim=True),
              _tn(nh[7], drawb), sum_draw, _tn(feat, dhv), _tn(ev, dhv),
              dhv.float().sum(0, keepdim=True), _tn(hv, drawb), sum_draw]
    return demb[:n], dembv[:n], grads


def encode_tile(pts: torch.Tensor, P: torch.Tensor, phase: torch.Tensor,
                rows: int) -> torch.Tensor:
    """`mlpe_bwd`'s encoding tile as the kernel writes it: thread t of
    warpgroup w encodes row 64 w + t // 2, lanes (t % 2) * 32 .. + 32, from
    its point (pts (128, 3) f32): pre = x0 P[0] + x1 P[1] + x2 P[2] (exact:
    P's entries are 0 or powers of two), lane < 3 ? pre : sin(pre + phase),
    rounded to bf16, zero from row `rows` on, each 8-lane piece stored at
    `tile_offset`. Returns the flat bf16 tile (128 x 64)."""
    pre = pts.float() @ P.float()
    lanes = torch.arange(KC)
    enc = torch.where(lanes < 3, pre, torch.sin(pre + phase)).to(torch.bfloat16)
    enc[rows:] = 0
    w, t, q = np.meshgrid(np.arange(2), np.arange(128), np.arange(4),
                          indexing="ij")
    r = (w * 64 + t // 2).reshape(-1, 1)
    cols = ((t % 2) * 32 + q * 8).reshape(-1, 1) + np.arange(8)
    out = torch.zeros(TM * KC, dtype=torch.bfloat16)
    r, cols = np.broadcast_arrays(r, cols)
    out[torch.from_numpy(tile_offset(r, cols).ravel())] = \
        enc[torch.from_numpy(r.ravel()), torch.from_numpy(cols.ravel())]
    return out


def fold_tile(products: Sequence[torch.Tensor], pts: torch.Tensor,
              P: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
    """dpts (128, 3) of one tile as `mlpe_bwd` folds demb onto its points.
    In the accumulator layout the thread of lane l holds columns 8 j + 2 (l %
    4) + e of its rows of each product (64 lanes, f32; dh6 @ n5e^T, then dh1
    @ n0w^T). It multiplies each value by cos(pre + phase) past lane 2 and by
    P[d] and adds it to its row's sum of coordinate d, product by product, j
    then e ascending, in f32; the four threads of a row (l % 4 = 0 .. 3) then
    add their sums as the shuffles by xor 1 and xor 2 do: (s0 + s1) + (s2 +
    s3)."""
    pre = pts.float() @ P.float()                       # exact (see above)
    lanes = torch.arange(KC)
    scale = torch.where(lanes < 3, torch.ones(()), torch.cos(pre + phase))
    sums = []
    for quad in range(4):
        s = torch.zeros(TM, 3)
        for prod in products:
            for j in range(KC // 8):
                for e in range(2):
                    col = 8 * j + 2 * quad + e
                    v = prod[:, col].float() * scale[:, col]
                    s = s + v[:, None] * P[:, col].float()[None, :]
        sums.append(s)
    return (sums[0] + sums[1]) + (sums[2] + sums[3])
