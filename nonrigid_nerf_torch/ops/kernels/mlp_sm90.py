"""The layouts of the Hopper chain (`csrc/mlp_sm90.cuh`) that `mlp_fwd`,
`mlp_bwd` and the other chain kernels launch, mirrored in Python, and the
weight images the wrappers pre-pack for them.

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
  `views_fwd_from_image`, `views_bwd_from_image`: the same for the
  view-direction images (the chain and the heads fw, vwf, vwv; the view
  layer's 8 or 16 KB of their 32 KB slots, `views_chunk_bytes`): `mlpv_bwd`
  reads all 78 chunks, `mlpv_fwd` the first 39 (the "fwd" part).
- `i8_schedule`, `pack_i8_image`, `unpack_i8_image`, `pack_i8_epilogue`,
  `i8_chain_from_image`: row 11's (`mlp_i8`) int8 image, whose swizzle rows
  hold 128 k-values (`tile_offset_i8`; 17 chunks of 32 KB, layer 5 in
  halves of 128 columns, qw5e's halves 16 KB copied), its epilogues'
  parameters (one float4 per column pair), and the chain read out of them
  with the kernel's integer sums and roundings (`requant_i8`,
  `quant_sym_i8`), which the CPU tests hold bit for bit against
  `mlp_i8_plain` up to h8.
- `pack_bend_image`, `unpack_bend_image`, `kmajor_offset`, `bend_from_image`:
  the bender's image (five K-major swizzled matrices, the 3-lane weights'
  rows, the f32 biases, P and the phase, 34,064 B, staged once per CTA;
  which the CTAs of rows 7-10 stage from the 18 weights, row 8's with b0l's
  rows after it at `BEND_IMAGE_PAD`) and a reader of the deformation field
  from it in the kernels' order (`bender_rows`).
- `bend_schedule`, `bend_fwd_rows_from_image`, `bend_b0l_rows`,
  `bend_bwd_transposes`, `bend_bwd_from_image`: rows 7 and 8 (`bend_fwd`,
  `bend_bwd`): the 64-point tiles each worker warpgroup walks, row 7's f32
  rows and row 10's pre-pass's bf16 rows, b0l's rows that row 8 stages
  after the image, the transposed B operands it reads, and its backward
  read out of what it stages in the kernel's order (tiles, k-steps of 16,
  the fixed-order sums).
- `encoding_pieces`, `encode_tile`, `fold_tile`: the in-kernel encoding of
  `mlpe_fwd` and `mlpe_bwd` (one device function), written into the
  swizzled tile piece by piece by the threads that write it (`mlpe_fwd`'s 96
  encoding warps' threads, `mlpe_bwd`'s consumer threads by row), and
  `mlpe_bwd`'s fold of demb onto the points in the order the threads sum.
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


def views_schedule(parts: Sequence[str] = IMAGE_PARTS
                   ) -> List[Tuple[str, int, int]]:
    """(layout, matrix, chunk) of every chunk of a view-direction image in
    the kernels' order (matrices as in `VIEWS_MATRIX_IDX`'s order). The
    "fwd" part, all that `mlpv_fwd` reads: the chain's forward chunks; fw
    (4), vwf (4), vwv (1) in the forward layout. The "bwd" part, which
    `mlpv_bwd` reads after it: vwf (4), vwv (1), fw (4) as the B operands of
    dhv @ vwf^T, dhv @ vwv^T and dfeat @ fw^T; the chain's backward chunks."""
    out = []
    for part in parts:
        if part == "fwd":
            out += [("fwd", m, c) for m, c in fwd_schedule(64)]
            out += [("fwd", FW, c) for c in range(NW // KC)]
            out += [("fwd", VWF, c) for c in range(NW // KC)] + [("fwd", VWV, 0)]
        elif part == "bwd":
            out += [("bwd", VWF, c) for c in range(NW // KC)] + [("bwd", VWV, 0)]
            out += [("bwd", FW, c) for c in range(NW // KC)]
            out += [("bwd", m, c) for m, c in bwd_schedule(64)]
        else:
            raise ValueError(f"image parts are {IMAGE_PARTS}, got {part!r}")
    return out


def _chunk_elems(layout: str, shape: Tuple[int, int]) -> int:
    rows, cols = shape
    return cols * KC if layout == "fwd" else min(KC, rows) * cols


def views_chunk_bytes(parts: Sequence[str] = IMAGE_PARTS) -> List[int]:
    """The bytes of each chunk of a view-direction image that the kernel's
    producer copies (the rest of its 32 KB slot is zero)."""
    shapes = _matrix_shapes(64, views=True)
    return [2 * _chunk_elems(layout, shapes[m])
            for layout, m, _ in views_schedule(parts)]


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


def views_index(parts: Sequence[str] = IMAGE_PARTS) -> np.ndarray:
    """For each element of a view-direction image, its index in the
    concatenation of its twelve flattened matrices, or -1 (zero)."""
    shapes = _matrix_shapes(64, views=True)
    bases = _bases(shapes)
    return np.concatenate([_chunk_index(layout, bases[m], shapes[m], c)
                           for layout, m, c in views_schedule(parts)])


_INDEX: Dict[tuple, torch.Tensor] = {}


def _cached_index(e: int, parts: Tuple[str, ...], device,
                  views: bool = False) -> torch.Tensor:
    """The image's index, -1 replaced by the position of a zero appended to
    the concatenated matrices."""
    key = (e, parts, views, str(device))
    if key not in _INDEX:
        if views:
            index = views_index(parts)
            total = _bases(_matrix_shapes(e, True))[-1]
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


def pack_views_image(mw: Sequence[torch.Tensor],
                     parts: Sequence[str] = IMAGE_PARTS) -> torch.Tensor:
    """The chunks of a view-direction image from the 26 cast weights, in
    the kernels' order (`views_schedule(parts)`), 16,384 bf16 elements a
    chunk: `("fwd",)` is what `mlpv_fwd` reads (39 chunks), both parts what
    `mlpv_bwd` reads (78)."""
    mats = [mw[i] for i in VIEWS_MATRIX_IDX]
    return _gather(mats, _cached_index(64, tuple(parts), mats[0].device,
                                       views=True))


def unpack_views_image(image: torch.Tensor,
                       parts: Sequence[str] = IMAGE_PARTS
                       ) -> List[torch.Tensor]:
    """The twelve matrices back from a view-direction image (each of its
    parts holds every element of every matrix once)."""
    shapes = _matrix_shapes(64, views=True)
    index = _cached_index(64, tuple(parts), image.device, views=True)
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


def views_fwd_from_image(embb: torch.Tensor, embvb: torch.Tensor,
                         image: torch.Tensor, mw: Sequence[torch.Tensor]
                         ) -> torch.Tensor:
    """raw (n, 8) f32 of `mlpv_fwd`, reading the chain's and the heads'
    matrices out of its image (`pack_views_image(mw, ("fwd",))`) chunk by
    chunk in the kernel's order, on 128-point tiles with rows past n zero:
    nh1 .. nh8; the alpha sums nh8 @ aw + ab + rb; feat over fw's 4 chunks;
    hv over vwf's 4 chunks, then vwv's; the rgb sums hv @ rw added to the
    alpha sums. Each product is summed in f32. The biases, aw and rw come
    from mw (the 26 cast weights), the rest from the image."""
    bf16 = torch.bfloat16
    n = embb.shape[0]
    sched = views_schedule(("fwd",))
    slots = image.view(-1, CHUNK_ELEMS)
    if slots.shape[0] != len(sched):
        raise ValueError(f"the forward's image has {len(sched)} chunks, got "
                         f"{slots.shape[0]}")
    shapes = _matrix_shapes(64, views=True)

    def chunk(m, c):
        return fwd_chunk_matrix(slots[sched.index(("fwd", m, c))], shapes[m][1])

    fb, aw, ab, vb, rw, rb = (mw[i] for i in (18, 19, 20, 23, 24, 25))
    nh8 = _tiles(chain_from_image(embb, image,
                                  [mw[i] for i in _CHAIN_BIASES])[7], n)
    s = _mm(nh8, aw) + ab.float() + rb.float()
    acc = 0.0
    for c in range(NW // KC):
        acc = acc + _mm(nh8[:, c * KC:(c + 1) * KC], chunk(FW, c))
    feat = (acc + fb.float()).to(bf16)
    acc = 0.0
    for c in range(NW // KC):
        acc = acc + _mm(feat[:, c * KC:(c + 1) * KC], chunk(VWF, c))
    acc = acc + _mm(_tiles(embvb.to(bf16), n), chunk(VWV, 0)[:VEMB])
    hv = torch.relu(acc + vb.float()).to(bf16)
    return (s + _mm(hv, rw))[:n]


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


ENCODERS = 96       # the forward's encoding warps: the producer's idle three


def encoding_pieces(writer: str = "rows") -> np.ndarray:
    """(writer, piece, 2): the (row, first lane) of every 8-lane piece of a
    128 x 64 encoding tile, by the thread that writes it. "rows" (`mlpe_bwd`,
    `PtsIn`): thread t of warpgroup w writes row 64 w + t // 2, lanes (t %
    2) * 32 .. + 32, 4 pieces. "encoders" (`mlpe_fwd`'s `PtsFwdIn` and
    `fused_fwd`'s `FusedFwdIn`): encoder e of 96 writes pieces q = e, e +
    96, ... of the 1,024 (row q // 8, lanes (q % 8) * 8), 11 or 10 of them
    (-1 rows pad the shorter lists)."""
    if writer == "rows":
        w, t, q = np.meshgrid(np.arange(2), np.arange(128), np.arange(4),
                              indexing="ij")
        rows = (w * 64 + t // 2).reshape(256, 4)
        lanes = ((t % 2) * 32 + q * 8).reshape(256, 4)
        return np.stack([rows, lanes], axis=-1)
    if writer == "encoders":
        pieces = TM * KC // 8
        q = np.arange(ENCODERS)[:, None] + ENCODERS * np.arange(
            -(-pieces // ENCODERS))[None, :]
        out = np.stack([q // 8, (q % 8) * 8], axis=-1)
        out[q >= pieces] = -1
        return out
    raise ValueError(f"writer is 'rows' or 'encoders', got {writer!r}")


def encode_tile(pts: torch.Tensor, P: torch.Tensor, phase: torch.Tensor,
                rows: int, writer: str = "rows") -> torch.Tensor:
    """The encoding tile of `mlpe_fwd` ("encoders") and `mlpe_bwd` ("rows")
    as the kernels write it (`encode_piece`), each thread its pieces of
    `encoding_pieces(writer)`, from their rows' points (pts (128, 3) f32):
    pre = x0 P[0] + x1 P[1] + x2 P[2] (exact: P's entries are 0 or powers of
    two), lane < 3 ? pre : sin(pre + phase), rounded to bf16, zero from row
    `rows` on, each 8-lane piece stored at `tile_offset`. Every element is
    written once. Returns the flat bf16 tile (128 x 64)."""
    pre = pts.float() @ P.float()
    lanes = torch.arange(KC)
    enc = torch.where(lanes < 3, pre, torch.sin(pre + phase)).to(torch.bfloat16)
    enc[rows:] = 0
    pieces = encoding_pieces(writer).reshape(-1, 2)
    pieces = pieces[pieces[:, 0] >= 0]
    r = np.repeat(pieces[:, :1], 8, axis=1)
    cols = pieces[:, 1:] + np.arange(8)
    offsets = tile_offset(r, cols).ravel()
    if len(offsets) != TM * KC or len(set(offsets.tolist())) != TM * KC:
        raise AssertionError(f"the {writer!r} pieces do not cover the tile once")
    out = torch.zeros(TM * KC, dtype=torch.bfloat16)
    out[torch.from_numpy(offsets)] = \
        enc[torch.from_numpy(r.ravel()), torch.from_numpy(cols.ravel())]
    return out


def points_data_lanes(lat_width: int) -> int:
    """The lanes of a row of `mlp_fwd_points`' input that its encoders
    write tile by tile: the 63 of the encoding and the latent's, to a whole
    number of 8-lane pieces; the kernel zeroes the rest once."""
    return -(-(63 + lat_width) // 8) * 8


def points_pieces(e: int, lat_width: int) -> Tuple[np.ndarray, np.ndarray]:
    """The writers of a 128 x e tile of `mlp_fwd_points`' input
    (`PointsFwdIn<E>`), as (row pieces, zero pieces), each (96, steps, 2):
    the (row, first lane) of the 8-lane piece encoder k stores at each step
    (-1 rows pad). Row pieces: encoder k builds rows k and k + 96 (< 128) in
    turn, lane by lane, a piece each 8 lanes up to `points_data_lanes`, so
    at each step a warp's threads store the same lanes of distinct rows.
    Zero pieces: this tile's share of the pieces past the data that encoder
    k zeroes when the kernel starts (piece q of both tiles' 2 x 128 x (e -
    data) / 8, q = k, k + 96, ...; tile q // that count)."""
    data = points_data_lanes(lat_width)
    per_row = data // 8
    rows = [[r for r in (k, k + ENCODERS) if r < TM] for k in range(ENCODERS)]
    steps = max(len(rs) for rs in rows) * per_row
    row_pieces = -np.ones((ENCODERS, steps, 2), np.int64)
    for k, rs in enumerate(rows):
        for i, (r, c) in enumerate((r, 8 * c) for r in rs
                                   for c in range(per_row)):
            row_pieces[k, i] = (r, c)
    zero = TM * (e - data) // 8
    zero_pieces = -np.ones((ENCODERS, -(-2 * zero // ENCODERS), 2), np.int64)
    for k in range(ENCODERS):
        for i, q in enumerate(range(k, 2 * zero, ENCODERS)):
            if q < zero:        # this tile's; q - zero are the other's
                zero_pieces[k, i] = (q % TM, data + (q // TM) * 8)
    return row_pieces, zero_pieces


def points_lane(x: torch.Tensor, lat: torch.Tensor, c: int) -> torch.Tensor:
    """Lane c of `PointsFwdIn`'s input for points x (r, 3) f32 and their
    rays' latents lat (r, L) f32, in f32, as `PointsFwdIn::row` computes
    it: x_c for c < 3; for octave k = (c - 3) // 6 and w = (c -
    3) % 6, sin (w < 3) or cos of x_(w % 3) * 2^k; lat[:, c - 63] for 63 <= c
    < 63 + L; else 0."""
    if c < 3:
        return x[:, c]
    if c < 63:
        k, w = divmod(c - 3, 6)
        v = x[:, w % 3] * float(2 ** k)
        return torch.sin(v) if w < 3 else torch.cos(v)
    if c - 63 < lat.shape[1]:
        return lat[:, c - 63]
    return torch.zeros(x.shape[0])


def points_tile(pts: torch.Tensor, lat: torch.Tensor, rows: int,
                e: int) -> torch.Tensor:
    """The encoding tile of `mlp_fwd_points` as its 96 encoders write it:
    the pieces of `points_pieces(e, L)`, lane by lane (`points_lane`),
    rounded to bf16, zero from row `rows` on, each 8-lane piece at
    `tile_offset`, the zero pieces zero: pts (128, 3) f32, lat (128, L) f32
    the latent of each row's ray (L = 0 at 64 lanes). Every element is
    written once. Returns the flat bf16 tile (128 x e)."""
    lanes = torch.stack([points_lane(pts, lat, c) for c in range(e)], 1)
    lanes = lanes.to(torch.bfloat16)
    lanes[rows:] = 0
    row_pieces, zero_pieces = points_pieces(e, lat.shape[1])
    pieces = np.concatenate([row_pieces.reshape(-1, 2),
                             zero_pieces.reshape(-1, 2)])
    pieces = pieces[pieces[:, 0] >= 0]
    r = np.repeat(pieces[:, :1], 8, axis=1)
    cols = pieces[:, 1:] + np.arange(8)
    offsets = tile_offset(r, cols).ravel()
    if len(set(offsets.tolist())) != TM * e or len(offsets) != TM * e:
        raise AssertionError("the pieces do not cover the tile once")
    out = torch.zeros(TM * e, dtype=torch.bfloat16)
    out[torch.from_numpy(offsets)] = \
        lanes[torch.from_numpy(r.ravel()), torch.from_numpy(cols.ravel())]
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


# ---- row 9 (`fused_fwd`, `FusedFwdIn`): the bender's image, staged once per
# CTA, and a reader of the deformation field in the kernel's order. A matrix
# W (K x N) of the products is kept as N K-major rows (row n holds column n
# of W): rows of 64 lanes (128 bytes) with the 16-byte pieces XORed with n %
# 8, rows of 32 lanes (64 bytes) XORed with (n // 2) % 4. The 3-lane weights
# follow as plain rows, then the f32 biases, P and the phase.

BEND_W, RIG_W, LAT_W = 64, 32, 32
# (index among the 18 cast bender weights, K, N, first element in the image):
# b0l, b1w, b2w, b3w, r1w
BEND_IMAGE_MATS = ((1, LAT_W, BEND_W, 0), (3, BEND_W, BEND_W, 2048),
                   (5, BEND_W, BEND_W, 6144), (7, BEND_W, BEND_W, 10240),
                   (12, RIG_W, RIG_W, 14336))
# then bow^T's rows 0 .. 2 (64 lanes), row's lane 0 (32), b0p's rows 0 .. 2
# (64 each), r0w's rows 0 .. 2 (32 each): (weight, first element, length)
BEND_IMAGE_ROWS = (("bowT", 15360, 3 * BEND_W), ("row", 15552, RIG_W),
                   ("b0p", 15584, 3 * BEND_W), ("r0w", 15776, 3 * RIG_W))
BEND_BF16_ELEMS = 15872         # the bf16 part, 31,744 B
# the f32 part: (weight, first float, length); rob's lane 0 padded to 4
BEND_IMAGE_F32 = (("b0b", 0, BEND_W), ("b1b", 64, BEND_W), ("b2b", 128, BEND_W),
                  ("b3b", 192, BEND_W), ("r0b", 256, RIG_W), ("r1b", 288, RIG_W),
                  ("rob", 320, 4), ("P", 324, 3 * 64), ("phase", 516, 64))
BEND_F32_FLOATS = 580
BEND_IMAGE_ELEMS = BEND_BF16_ELEMS + 2 * BEND_F32_FLOATS    # 34,064 B


def kmajor_offset(n, k, lanes: int):
    """Element offset of (n, k) in a K-major image matrix whose rows hold
    `lanes` (32 or 64) k-values, as the device code's `kmajor_offset` has it
    (in bytes)."""
    sw = n % 8 if lanes == 64 else (n // 2) % 4
    return n * lanes + ((k // 8) ^ sw) * 8 + k % 8


def bend_image_index() -> np.ndarray:
    """For each element of the bender's image's bf16 part, its index in the
    concatenation of b0l, b1w, b2w, b3w and r1w, flattened (in, out), then
    the 3-lane rows of `BEND_IMAGE_ROWS` in order."""
    out = np.full(BEND_BF16_ELEMS, -1, np.int64)
    src_base = 0
    for _, k_lanes, n_cols, base in BEND_IMAGE_MATS:
        k = np.arange(k_lanes)[:, None]
        n = np.arange(n_cols)[None, :]
        out[base + kmajor_offset(n, k, k_lanes)] = src_base + k * n_cols + n
        src_base += k_lanes * n_cols
    for _, base, length in BEND_IMAGE_ROWS:
        out[base:base + length] = src_base + np.arange(length)
        src_base += length
    return out


# row 8's backward image: the forward image, zero up to BEND_IMAGE_PAD
# elements (1024-byte aligned), then b0l's rows (row i holds b0l[i, :],
# K-major, 64 lanes: the B operand of dlat = dbh0 @ b0l^T), as its CTAs
# stage them from the weights
BEND_IMAGE_PAD = 17408

_BEND_INDEX: Dict[str, torch.Tensor] = {}


def _bend_index(device) -> torch.Tensor:
    key = str(device)
    if key not in _BEND_INDEX:
        _BEND_INDEX[key] = torch.from_numpy(bend_image_index()).to(device)
    return _BEND_INDEX[key]


def _bend_rows(bw: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The 3-lane weights as the image keeps them: bow^T[:3], row[:, 0],
    b0p[:3], r0w[:3]."""
    return [bw[9][:, :3].t(), bw[14][:, 0], bw[0][:3], bw[10][:3]]


def _bend_f32(bw: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The image's f32 part: b0b .. b3b, r0b, r1b, rob's lane 0 (and 3
    zeros), P's rows 0 .. 2, the phase."""
    rob = torch.cat([bw[15].reshape(-1)[:1], bw[15].new_zeros(3)])
    return [bw[2], bw[4], bw[6], bw[8], bw[11], bw[13], rob, bw[16][:3], bw[17]]


def pack_bend_image(bw: Sequence[torch.Tensor]) -> torch.Tensor:
    """The bender's image from its 18 cast weights (`cast_bend_weights`):
    b0l, b1w, b2w, b3w and r1w as K-major swizzled rows, the 3-lane weights'
    rows, then the f32 biases, P and the phase (`BEND_IMAGE_F32`, two bf16
    elements a float); a flat bf16 tensor of 17,032 elements, the bytes the
    kernels of rows 7-10 stage into shared memory from the weights
    (`stage_bend_image` of `csrc/mlp_sm90.cuh`)."""
    flat = torch.cat([bw[i].reshape(-1) for i, *_ in BEND_IMAGE_MATS]
                     + [t.reshape(-1) for t in _bend_rows(bw)])
    f32 = torch.cat([t.float().reshape(-1) for t in _bend_f32(bw)])
    return torch.cat([flat[_bend_index(flat.device)], f32.view(torch.bfloat16)])


def unpack_bend_image(image: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The bender's image's contents by name: b0l, b1w, b2w, b3w and r1w (in,
    out), bowT (3, 64), row (32,), b0p (3, 64), r0w (3, 32) (bf16); b0b ..
    b3b, r0b, r1b, rob (4,), P (3, 64), phase (64,) (f32)."""
    flat = torch.empty(BEND_BF16_ELEMS, dtype=image.dtype, device=image.device)
    flat[_bend_index(image.device)] = image[:BEND_BF16_ELEMS]
    names = ["b0l", "b1w", "b2w", "b3w", "r1w", "bowT", "row", "b0p", "r0w"]
    shapes = [(k_lanes, n_cols) for _, k_lanes, n_cols, _ in BEND_IMAGE_MATS]
    shapes += [(3, BEND_W), (RIG_W,), (3, BEND_W), (3, RIG_W)]
    out, off = {}, 0
    for name, shape in zip(names, shapes):
        size = int(np.prod(shape))
        out[name] = flat[off:off + size].view(shape)
        off += size
    f32 = image[BEND_BF16_ELEMS:BEND_IMAGE_ELEMS].contiguous().view(torch.float32)
    for name, first, length in BEND_IMAGE_F32:
        out[name] = f32[first:first + length]
    out["P"] = out["P"].view(3, 64)
    return out


def _ksteps(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (R, K) @ w (K, N) as the warps sum it: a product per k-step of 16,
    the k-steps added in ascending order, each column's sum from 0, f32."""
    acc = torch.zeros(a.shape[0], w.shape[1])
    for k0 in range(0, a.shape[1], 16):
        acc = acc + _mm(a[:, k0:k0 + 16], w[k0:k0 + 16])
    return acc


def _seq(terms) -> torch.Tensor:
    """The terms added in order, from 0, in f32 (a sequential sum)."""
    s = 0.0
    for t in terms:
        s = s + t
    return s


def _bend_acts(pts: torch.Tensor, lat: torch.Tensor, im: Dict[str, torch.Tensor]):
    """The deformation field's activations as `bender_rows` computes them, on
    whole 128-point tiles (zero points and latents past n): the products by
    k-steps of 16 (`_ksteps`), the 3-lane products as sequential f32 sums of
    exact products (pts @ b0p and pts @ r0w over the 3 coordinates, bh3 @ bow
    over 64 lanes, rh1 @ row over 32), (pre + acc) + bias, ReLU, bf16; t =
    tanh, rig = (t + 1) * 0.5, bent = x + rig * off. A row's arithmetic does
    not depend on its tile."""
    bf16 = torch.bfloat16
    b0l, b1w, b2w, b3w, r1w = (im[k] for k in ("b0l", "b1w", "b2w", "b3w", "r1w"))
    bowt, row, b0p, r0w = (im[k] for k in ("bowT", "row", "b0p", "r0w"))
    b0b, b1b, b2b, b3b, r0b, r1b, rob = (
        im[k] for k in ("b0b", "b1b", "b2b", "b3b", "r0b", "r1b", "rob"))
    n = pts.shape[0]
    x = _tiles(pts.float(), n)
    xb = x.to(bf16).float()
    lb = _tiles(lat.float(), n).to(bf16)
    pre = _seq(xb[:, j:j + 1] * b0p[j].float() for j in range(3))
    bh = [torch.relu((pre + _ksteps(lb, b0l)) + b0b.float()).to(bf16)]
    for w, b in ((b1w, b1b), (b2w, b2b), (b3w, b3b)):
        bh.append(torch.relu((0.0 + _ksteps(bh[-1], w)) + b.float()).to(bf16))
    off = torch.stack([_seq(bh[3][:, k].float() * bowt[j, k].float()
                            for k in range(BEND_W)) for j in range(3)], dim=1)
    rs = _seq(xb[:, j:j + 1] * r0w[j].float() for j in range(3))
    rh0 = torch.relu(rs + r0b.float()).to(bf16)
    rh1 = torch.relu((0.0 + _ksteps(rh0, r1w)) + r1b.float()).to(bf16)
    t = torch.tanh(_seq(rh1[:, k].float() * row[k].float()
                        for k in range(RIG_W)) + rob[0])
    rig = (t + 1.0) * 0.5
    bent = x + rig[:, None] * off
    return dict(x=x, xb=xb, lb=lb, bh=bh, rh0=rh0, rh1=rh1, t=t, rig=rig, off=off,
                bent=bent)


def bend_from_image(pts: torch.Tensor, lat: torch.Tensor, image: torch.Tensor):
    """The deformation field as `bender_rows` runs it (`_bend_acts`),
    everything it reads but the points and latents read out of the bender's
    image. Returns the f32 encoding of the bent points (rows 9 and 10's
    pre-pass round it to bf16 as they write it), the offsets (n, 3) and the
    rigidity (n, 1); rows past n dropped."""
    im = unpack_bend_image(image)
    n = pts.shape[0]
    a = _bend_acts(pts, lat, im)
    bent, P = a["bent"], im["P"]
    pre_e = bent[:, 0:1] * P[0] + bent[:, 1:2] * P[1] + bent[:, 2:3] * P[2]
    emb = torch.where(torch.arange(EMB) < 3, pre_e, torch.sin(pre_e + im["phase"]))
    return emb[:n], a["off"][:n], a["rig"][:n, None]


# ---- rows 7 and 8 (`bend_fwd`, `bend_bwd`; row 10's pre-pass and bender
# backward): tiles of 64 points, each walked by one warpgroup (a worker)

BEND_TILE = 64


def bend_schedule(n_blocks: int, ctas: int, per_cta: int) -> List[List[int]]:
    """The tiles (64 points each) of each worker in the order it walks them:
    worker w = cta * per_cta + k takes tiles w, w + ctas * per_cta, ..."""
    workers = ctas * per_cta
    return [list(range(w, n_blocks, workers)) for w in range(workers)]


def bend_fwd_rows_from_image(pts: torch.Tensor, lat: torch.Tensor, image: torch.Tensor,
                             bf16_rows: bool = False) -> torch.Tensor:
    """The encoding rows `bend_fwd_sm90_kernel` writes: row 7's f32 rows
    below n (n, 64), or row 10's pre-pass's bf16 rows of whole 128-point
    tiles (n_pad, 64), zero past n."""
    emb = bend_from_image(pts, lat, image)[0]
    if not bf16_rows:
        return emb
    n = pts.shape[0]
    rows = torch.zeros(-(-n // TM) * TM, EMB, dtype=torch.bfloat16)
    rows[:n] = emb.to(torch.bfloat16)
    return rows


def bend_b0l_rows(b0l: torch.Tensor) -> torch.Tensor:
    """What row 8's CTAs stage after the image, at `BEND_IMAGE_PAD`: b0l's
    32 rows (row i holds b0l[i, :]) K-major in the 128-byte swizzle, a flat
    tensor of 2,048 elements."""
    i = np.arange(LAT_W)[:, None]
    o = np.arange(BEND_W)[None, :]
    out = torch.empty(LAT_W * BEND_W, dtype=b0l.dtype)
    out[torch.from_numpy(kmajor_offset(i, o, BEND_W).ravel())] = b0l.reshape(-1)
    return out


def bend_bwd_transposes(image: torch.Tensor, b0l_rows: torch.Tensor
                        ) -> Dict[str, torch.Tensor]:
    """The B operands of the backward's transposed products as the kernel
    reads them: b1w^T, b2w^T, b3w^T (64 x 64; the image's K-major rows of
    W^T read MN-major, B[k][n] at row k, lane n of the swizzled rows:
    W[n][k]) and b0l^T (64 x 32; `bend_b0l_rows` read K-major, B[k][n] =
    b0l[n][k])."""
    k = np.arange(BEND_W)[:, None]
    n = np.arange(BEND_W)[None, :]
    out = {}
    for name, (_, _, _, base) in zip(("b1wT", "b2wT", "b3wT"), BEND_IMAGE_MATS[1:4]):
        out[name] = image[torch.from_numpy(base + kmajor_offset(k, n, BEND_W).ravel())].view(
            BEND_W, BEND_W)
    rows = np.arange(LAT_W)[None, :]
    out["b0lT"] = b0l_rows[torch.from_numpy(
        kmajor_offset(rows, k, BEND_W).ravel())].view(BEND_W, LAT_W)
    return out


def bend_bwd_from_image(pts: torch.Tensor, lat: torch.Tensor, bw: Sequence[torch.Tensor],
                        demb: torch.Tensor, doff: torch.Tensor, drig: torch.Tensor,
                        ctas: int = 1, per_cta: int = 2):
    """dpts (n, 3), dlat (n, 32) and the 16 f32 gradients (pack order, padded
    as packed) as `bend_bwd_sm90_kernel` computes them from what it stages
    of the 18 cast weights bw (`pack_bend_image`, then `bend_b0l_rows`): the
    forward of `_bend_acts`;
    dbent (demb folded onto each coordinate: its 20 sine lanes in two
    halves, each in ascending order, added to the coordinate's own lane),
    doff_t and drig_raw a row; the
    cotangent chain with its casts where the JAX math casts, dbh_{l-1} =
    dbh_l @ b_lw^T and dlat = dbh0 @ b0l^T by k-steps of 16 on the operands
    of `bend_bwd_transposes`; the weight gradients summed tile by tile (64
    points, their products by k-steps of 16 points) in the order each
    worker of `bend_schedule(ceil(n / 64), ctas, per_cta)` walks them (rob,
    a sum whose terms cancel, in f64 a worker), a CTA's workers added in
    order, the CTAs in ascending order. Rows past n carry zero cotangents."""
    image = pack_bend_image(bw)
    bf16 = torch.bfloat16
    im = unpack_bend_image(image)
    tr = bend_bwd_transposes(image, bend_b0l_rows(bw[1]))
    n = pts.shape[0]
    a = _bend_acts(pts, lat, im)
    rows = a["x"].shape[0]
    valid = (torch.arange(rows) < n)[:, None]
    dm, do, dr = (_tiles(c.float(), n) for c in (demb, doff, drig))
    P, phase = im["P"], im["phase"]

    def r(v):
        return v.to(bf16).float()

    # dbent: two threads a row sum the sine lanes m = 0 .. 9 and 10 .. 19 of
    # coordinate j in order; then (its own lane + the first) + the second
    pre = a["bent"] @ P + phase         # the sines' arguments, exact products
    cols = []
    for j in range(3):
        halves = []
        for ms in (range(0, 10), range(10, 20)):
            s = torch.zeros(rows)
            for m in ms:
                c = 3 + 3 * m + j
                s = s + (dm[:, c] * torch.cos(pre[:, c])) * P[j, c]
            halves.append(s)
        cols.append((dm[:, j] + halves[0]) + halves[1])
    dbent = torch.where(valid, torch.stack(cols, dim=1), torch.zeros(()))
    doff_t = dbent * a["rig"][:, None] + do
    drig0 = _seq(dbent[:, j] * a["off"][:, j] for j in range(3))
    drig_raw = ((dr[:, 0] + drig0) * 0.5) * (1.0 - a["t"] * a["t"])
    # the rigidity's backward (CUDA cores)
    drh1 = _mask(r(drig_raw)[:, None] * im["row"].float()[None, :], a["rh1"])
    drh0 = _mask(drh1.float() @ im["r1w"].float().t(), a["rh0"])
    dpts_rig = drh0.float() @ im["r0w"].float().t()
    # the bending layers
    bh = a["bh"]
    dot = r(doff_t)
    dbh = [None, None, None,
           _mask(_seq(dot[:, j:j + 1] * im["bowT"][j].float()[None, :] for j in range(3)),
                 bh[3])]
    for l in (3, 2, 1):
        dbh[l - 1] = _mask(_ksteps(dbh[l], tr[f"b{l}wT"]), bh[l - 1])
    dlat = _ksteps(dbh[0], tr["b0lT"])
    dpts = (dbent + dpts_rig) + dbh[0].float() @ im["b0p"].float().t()

    def ksteps_tn(act, g):           # act^T @ g over 64 points by steps of 16
        acc = 0.0
        for k0 in range(0, BEND_TILE, 16):
            acc = acc + act[k0:k0 + 16].float().t() @ g[k0:k0 + 16].float()
        return acc

    def tile_grads(sl):
        xb = a["xb"][sl]
        grads = [xb.t() @ dbh[0][sl].float(), ksteps_tn(a["lb"][sl], dbh[0][sl]),
                 dbh[0][sl].float().sum(0, keepdim=True)]
        for l in (1, 2, 3):
            grads += [ksteps_tn(bh[l - 1][sl], dbh[l][sl]),
                      dbh[l][sl].float().sum(0, keepdim=True)]
        grads += [bh[3][sl].float().t() @ dot[sl], xb.t() @ drh0[sl].float(),
                  drh0[sl].float().sum(0, keepdim=True),
                  a["rh0"][sl].float().t() @ drh1[sl].float(),
                  drh1[sl].float().sum(0, keepdim=True),
                  a["rh1"][sl].float().t() @ r(drig_raw[sl])[:, None],
                  drig_raw[sl].double().sum().reshape(1, 1)]   # rob: f64 a worker
        return grads

    n_blocks = -(-n // BEND_TILE)
    sched = bend_schedule(n_blocks, ctas, per_cta)
    total = None
    for c in range(ctas):
        partial = None
        for w in sched[c * per_cta:(c + 1) * per_cta]:
            sums = None
            for b in w:
                g = tile_grads(slice(b * BEND_TILE, (b + 1) * BEND_TILE))
                sums = g if sums is None else [x + y for x, y in zip(sums, g)]
            if sums is not None:
                sums = [x.float() for x in sums]
                partial = sums if partial is None else [x + y for x, y in zip(partial, sums)]
        if partial is not None:
            total = partial if total is None else [x + y for x, y in zip(total, partial)]
    shapes = ((8, BEND_W), (LAT_W, BEND_W), (1, BEND_W), (BEND_W, BEND_W), (1, BEND_W),
              (BEND_W, BEND_W), (1, BEND_W), (BEND_W, BEND_W), (1, BEND_W), (BEND_W, 8),
              (8, RIG_W), (1, RIG_W), (RIG_W, RIG_W), (1, RIG_W), (RIG_W, 8), (1, 8))
    grads = [torch.nn.functional.pad(g, (0, s[1] - g.shape[1], 0, s[0] - g.shape[0]))
             for g, s in zip(total, shapes)]
    return dpts[:n], dlat[:n], grads


# ---- row 11 (`mlp_i8`): the int8 chain's image, its epilogue parameters and
# a reader of the chain from them. An int8 swizzle row holds 128 k-values
# (128 bytes): a chunk is 128 k-values of 256 columns (32 KB, a ring stage),
# element (n, k) at `n * 128 + (k // 16 ^ n % 8) * 16 + k % 16` of its
# k-atom, holding W[k0 + k, n0 + n].

I8_K = 128                      # int8 k-values of a swizzle row
I8_CHUNK_BYTES = I8_K * NW      # 32 KB
# the rows of the nine int8 matrices as `nrnerf_mlp_i8` reads them: qw0,
# qw1 .. qw4, qw5e, qw5h, qw6, qw7
I8_ROWS = (64, NW, NW, NW, NW, 64, NW, NW, NW)
I8_MAGIC = 12582912.0           # 1.5 * 2^23
EMB = 64                        # the encoding's lanes


def tile_offset_i8(row, col):
    """Byte offset of (row, col) in an int8 tile of 128 rows (numpy arrays or
    ints): k-atom col // 128, row, 16-byte piece XOR row % 8."""
    return ((col // I8_K) * TM * I8_K + row * I8_K
            + (((col // 16) % 8) ^ (row % 8)) * 16 + col % 16)


def i8_schedule() -> List[Tuple[int, int, int, int, int]]:
    """(matrix, k0, n0, columns, k-atoms) of every chunk of the int8 image in
    the kernel's order, matrices as in `I8_ROWS`: qw0 (its 64 rows in one
    128-deep atom); qw1 .. qw4 in two chunks of 128 rows; layer 5 in halves of
    128 columns, each qw5e's (64 rows) then qw5h's (256 rows as two k-atoms of
    128 columns); qw6, qw7 as qw1. 17 chunks."""
    half = NW // 2
    out = [(0, 0, 0, NW, 1)]
    for m in (1, 2, 3, 4):
        out += [(m, c * I8_K, 0, NW, 1) for c in range(NW // I8_K)]
    for h in range(2):
        out += [(5, 0, h * half, half, 1), (6, 0, h * half, half, NW // I8_K)]
    for m in (7, 8):
        out += [(m, c * I8_K, 0, NW, 1) for c in range(NW // I8_K)]
    return out


def i8_chunk_bytes() -> List[int]:
    """The bytes of each chunk that the kernel's producer copies (the rest of
    its 32 KB slot is zero): 16 KB for qw5e's halves, 32 KB for the rest."""
    return [cols * I8_K * atoms for _, _, _, cols, atoms in i8_schedule()]


def _i8_pos(cols: int, atoms: int) -> np.ndarray:
    """(cols, atoms * 128): the byte of element (n, k) of a chunk."""
    n = np.arange(cols)[:, None]
    k = np.arange(atoms * I8_K)[None, :]
    return (k // I8_K) * (cols * I8_K) + tile_offset_i8(n, k % I8_K)


def i8_image_index() -> np.ndarray:
    """For each byte of the int8 image, its index in the concatenation of the
    nine flattened matrices, or -1 (zero: rows past a matrix's end, and the
    rest of qw5e's slots)."""
    bases = _bases([(r, NW) for r in I8_ROWS])
    pieces = []
    for m, k0, n0, cols, atoms in i8_schedule():
        out = np.full(I8_CHUNK_BYTES, -1, np.int64)
        k = np.arange(atoms * I8_K)[None, :]
        n = np.arange(cols)[:, None]
        src = np.where(k0 + k < I8_ROWS[m], bases[m] + (k0 + k) * NW + n0 + n, -1)
        out[_i8_pos(cols, atoms).ravel()] = src.ravel()
        pieces.append(out)
    return np.concatenate(pieces)


def _cached_i8_index(device) -> torch.Tensor:
    key = ("i8", str(device))
    if key not in _INDEX:
        index = i8_image_index()
        total = _bases([(r, NW) for r in I8_ROWS])[-1]
        _INDEX[key] = torch.from_numpy(np.where(index < 0, total, index)).to(
            device)
    return _INDEX[key]


def pack_i8_image(mats: Sequence[torch.Tensor]) -> torch.Tensor:
    """The int8 chain's image from its nine int8 matrices (qw0, qw1 .. qw4,
    qw5e, qw5h, qw6, qw7, each (in, 256)): 17 chunks of 32 KB in the
    kernel's order and layout (`i8_schedule`). One gather from a cached
    index; no matrix is transposed."""
    return _gather(mats, _cached_i8_index(mats[0].device))


def unpack_i8_image(image: torch.Tensor) -> List[torch.Tensor]:
    """The nine int8 matrices back from the image (it holds every element of
    every matrix once)."""
    index = _cached_i8_index(image.device)
    total = sum(r * NW for r in I8_ROWS)
    flat = torch.zeros(total + 1, dtype=image.dtype, device=image.device)
    flat[index] = image
    out, off = [], 0
    for r in I8_ROWS:
        out.append(flat[off:off + r * NW].view(r, NW))
        off += r * NW
    return out


def pack_i8_epilogue(deqs: Sequence[torch.Tensor],
                     biases: Sequence[torch.Tensor]) -> torch.Tensor:
    """The epilogues' parameters as the kernel reads them, one float4 per
    column pair: (9, 128, 4) f32, row l < 8 (d[2p], d[2p + 1], b[2p], b[2p +
    1]) of layer l (layer 5: d5h, b5), row 8 (d5e[2p], d5e[2p + 1], 0, 0).
    deqs: d0, d1 .. d4, d5e, d5h, d6, d7; biases: b0 .. b7."""
    d = torch.stack([x.reshape(NW) for x in
                     (*deqs[:5], deqs[6], deqs[7], deqs[8], deqs[5])]).float()
    b = torch.stack([x.reshape(NW) for x in biases]
                    + [biases[0].new_zeros(NW)]).float()
    return torch.stack([d.view(9, NW // 2, 2), b.view(9, NW // 2, 2)],
                       dim=2).reshape(9, NW // 2, 4)


def i8_chunk_matrix(slot: torch.Tensor, cols: int = NW,
                    atoms: int = 1) -> torch.Tensor:
    """A chunk of the int8 image as the (128 * atoms, cols) weight rows it
    holds (rows past the matrix's end are zero)."""
    return slot[torch.from_numpy(_i8_pos(cols, atoms))].t()


def requant_i8(v: torch.Tensor, m) -> torch.Tensor:
    """The kernel's requantization of a pre-activation, rint(min(relu(v) *
    m, 254)) - 127: relu(v) * m plus 1.5 * 2^23 rounds to an integer in the
    low mantissa bits; 1.5 * 2^23 + 127 less, clipped above at 127."""
    y = torch.relu(v) * m + I8_MAGIC
    q = torch.clamp(y.view(torch.int32) - (0x4B400000 + 127), max=127)
    return q.to(torch.int8)


def quant_sym_i8(x: torch.Tensor, m) -> torch.Tensor:
    """The encoders' symmetric quantization rint(clip(x * m, -127, 127)),
    rounded as `requant_i8` and read off the low byte of the float's bits."""
    y = torch.clamp(x * m, -127.0, 127.0) + I8_MAGIC
    return (y.view(torch.int32) & 0xFF).to(torch.uint8).view(torch.int8)


def _mm_s32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (a.long() @ w.long()).int()


def i8_chain_from_image(embb: torch.Tensor, image: torch.Tensor,
                        epi: torch.Tensor, qm: torch.Tensor, ow: torch.Tensor,
                        ob: torch.Tensor):
    """`mlp_i8`'s chain as the kernel runs it, on 128-point tiles (zero past
    n), reading the weights out of its image chunk by chunk in its order and
    the epilogues' parameters out of `pack_i8_epilogue`'s rows, with its
    integer sums and its roundings: qemb; q1 .. q5; layer 5
    in halves of 128 columns, ((f32(a) d5h) + (f32(e) d5e)) + b5; q7; h8;
    the bf16 head. Returns ([qemb, q1 .. q7] int8, h8 f32, raw f32), rows
    past n dropped."""
    n = embb.shape[0]
    m = qm.reshape(-1).float()
    d = epi[..., :2].reshape(9, NW)
    b = epi[..., 2:].reshape(9, NW)
    sched = i8_schedule()
    chunks = iter(i8_chunk_matrix(slot, cols, atoms) for slot, (_, _, _, cols, atoms)
                  in zip(image.view(-1, I8_CHUNK_BYTES), sched))
    qemb = quant_sym_i8(_tiles(embb.to(torch.bfloat16).float(), n), m[0])
    acts, q, h8 = [qemb], qemb, None
    for layer in range(8):
        if layer == 5:
            q6 = torch.empty_like(q)
            for h in range(2):
                cols = slice(h * NW // 2, (h + 1) * NW // 2)
                e = _mm_s32(qemb, next(chunks)[:EMB])
                a = _mm_s32(q, next(chunks))
                v = (a.float() * d[5, cols] + e.float() * d[8, cols]) + b[5, cols]
                q6[:, cols] = requant_i8(v, m[6])
            q = q6
        else:
            if layer == 0:
                acc = _mm_s32(qemb, next(chunks)[:EMB])
            else:
                acc = sum(_mm_s32(q[:, c * I8_K:(c + 1) * I8_K], next(chunks))
                          for c in range(NW // I8_K))
            v = acc.float() * d[layer] + b[layer]
            if layer == 7:
                h8 = torch.relu(v)
                break
            q = requant_i8(v, m[layer + 1])
        acts.append(q)
    raw = h8.to(torch.bfloat16).float() @ ow.float() + ob.float()
    return [a[:n] for a in acts], h8[:n], raw[:n]
