"""Public entry points of the spectral lossy codec.

``spectral_compress_tree(state, eps, policy)`` is the device stage of the
hybrid checkpoint pipeline: the leaves the policy selects are compressed
in fused dispatches over packed buffers of at most :data:`GROUP_BYTES`
(one dispatch for every leaf of full-width smollm-135m), through the
tiled kernels of
:mod:`repro_torch.kernels.spectral_lossy` on a CUDA state and through
their plain versions on a CPU state. ``spectral_compress`` (and its
chunked variant, and ``compress_in_graph``) compresses one tensor: the
lossy stage of the SYNC and ASYNC checkpoint placements and of the
``spectral`` codecs. ``spectral_decompress`` is restore's device stage
(the dequantise + inverse DCT kernel).

The single-tensor selection takes the JAX package's two routes: on the
card the two-level one through the single-tensor kernels
(``dct_hist_coarse``, the coarse bin that straddles the budget,
``hist_refine`` inside it), as the JAX package does on the TPU; on the
CPU the flat 512-bin oracle, as the JAX package does off the TPU. Both
land on the same bin edge (the two-level selector is the flat one
computed in two passes), so a CPU and a card run give the same
thresholds, q and scales.

The JAX package autotunes its tiles per pow2 shape bucket on the TPU; the
port's kernels use their own fixed tiles, so nothing here tunes.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.core import pytree
from repro_torch.kernels import ref, spectral_lossy as K
from repro_torch.kernels.ref import BLOCK, Compressed

PyTree = Any


def _pad_blocks(xb: torch.Tensor, tile: int) -> torch.Tensor:
    pad = (-xb.shape[0]) % tile
    if pad:
        xb = torch.nn.functional.pad(xb, (0, 0, 0, pad))
    return xb


def select_flat(xb: torch.Tensor, eps: float):
    """The flat 512-bin selection on padded blocks -> (y, threshold): the
    single-tensor route on the CPU (the JAX package's off the TPU)."""
    y = ref.dct_blocks(xb)
    _, energies = ref.energy_histogram(y)
    return y, ref.threshold_from_histogram(energies, eps)


def select_two_level(xb: torch.Tensor, eps: float):
    """The two-level selection through the single-tensor kernels on
    padded blocks -> (y, threshold): the route on the card (the JAX
    package's on the TPU). On CPU tensors the kernels' plain versions run
    it (the tests hold it against the flat route there)."""
    y, _, ce = K.dct_hist_coarse(xb)
    c, cc, base, budget = ref.select_coarse(ce, eps)
    _, fe = K.hist_refine(y, cc)
    return y, ref.select_fine(fe, c, cc, base, budget)


def _compress_blocks(x: torch.Tensor, eps: float):
    """(q, scale, n_elements) of one tensor, each route on its device."""
    xb, n = ref.blockize(x)
    xb = _pad_blocks(xb, K.HIST_TILE)
    select = select_flat if xb.device.type == "cpu" else select_two_level
    y, t = select(xb, float(eps))
    q, scale = K.threshold_quant(y, t)
    return q, scale, n


def spectral_compress(x: torch.Tensor, eps: float = 1e-2) -> Compressed:
    """Lossy-compress one tensor where it lives. Relative-L2 error <~ eps
    + quant."""
    q, scale, n = _compress_blocks(x, eps)
    return Compressed(q, scale, n, tuple(x.shape), x.dtype)


def spectral_compress_chunked(x: torch.Tensor, eps: float = 1e-2, *,
                              chunk_blocks: int = 4096):
    """``spectral_compress`` with the int8 coefficients split into
    ``chunk_blocks``-row slices of the same buffer (4096 blocks x 256 B =
    the codec's 1 MiB frame chunk), so the host framing can copy and pack
    chunk by chunk. Returns ``(chunks, scale, n_elements)``; ``cat(chunks)``
    equals ``spectral_compress(x, eps).q``."""
    q, scale, n = _compress_blocks(x, eps)
    chunks = tuple(q[off:off + chunk_blocks]
                   for off in range(0, q.shape[0], chunk_blocks))
    return chunks, scale, n


def spectral_decompress(c: Compressed) -> torch.Tensor:
    """Dequantise + inverse DCT (the kernel on a CUDA ``q``), unpadded to
    the original shape and dtype."""
    xb = K.dequant_idct(c.q, c.scale)
    return ref.unblockize(xb, c.n_elements, c.shape, c.dtype)


def _segment_rows(rows: torch.Tensor, bounds: list[tuple[int, int]]
                  ) -> torch.Tensor:
    """Per-leaf sums of per-tile histogram rows. Leaves sit contiguously,
    so each is one slice, summed in a fixed order (no scatter atomics: the
    result does not change from run to run)."""
    return torch.stack([rows[a:b].sum(0) for a, b in bounds])


def _compress_packed(packed: torch.Tensor, rows: list[int], eps: float):
    """ONE fused dispatch over a packed (total_rows, BLOCK) buffer whose
    leaves each hold ``rows[i]`` blocks (a multiple of the histogram tile),
    with thresholds *per leaf*: two-level selection with per-tile
    histograms summed back to each leaf. Returns (q, scale) of the whole
    buffer."""
    tile = K.HIST_TILE
    tiles = [r // tile for r in rows]
    bounds, off = [], 0
    for n in tiles:
        bounds.append((off, off + n))
        off += n
    n_rows = torch.tensor(rows, device=packed.device)

    def per_block(v: torch.Tensor) -> torch.Tensor:
        # output_size given: no device sync to size the result
        return torch.repeat_interleave(v, n_rows, output_size=sum(rows))

    y, _, eng_t = K.dct_hist_coarse_tiled(packed, tile=tile)
    c, cc, base, budget = ref.select_coarse(_segment_rows(eng_t, bounds), eps)
    _, fine_t = K.hist_refine_tiled(y, per_block(cc.to(torch.int32)),
                                    tile=tile)
    t_leaf = ref.select_fine(_segment_rows(fine_t, bounds), c, cc, base,
                             budget)
    return K.threshold_quant(y, per_block(t_leaf))


#: f32 bytes of one fused dispatch's packed buffer (kernel 2 writes a
#: second buffer, ``y``, of the same size). Full-width smollm-135m's
#: moments, 1,050,928 blocks (1.08 GB), are one group; hymba-1.5b's (13.3
#: GB) and xlstm-1.3b's (28.9 GB) are several, each packed and compressed
#: in turn, so a save holds one group's two buffers at a time.
GROUP_BYTES = 2 << 30


def _groups(rows: list[int], group_bytes: int) -> list[list[int]]:
    """Consecutive leaves (by index) in groups of at most ``group_bytes``
    f32 bytes; a leaf larger than the bound is a group of its own."""
    groups: list[list[int]] = []
    size = 0
    for i, r in enumerate(rows):
        nbytes = r * BLOCK * 4
        if groups and size + nbytes <= group_bytes:
            groups[-1].append(i)
            size += nbytes
        else:
            groups.append([i])
            size = nbytes
    return groups


def _pack(leaves: list[torch.Tensor], rows: list[int]) -> torch.Tensor:
    """``leaves`` in one f32 (sum(rows), BLOCK) buffer, each leaf in its
    slice of ``rows`` blocks (the tails stay 0)."""
    packed = torch.zeros((sum(rows), BLOCK), dtype=torch.float32,
                         device=leaves[0].device)
    flat_buf = packed.view(-1)
    off = 0
    for leaf, r in zip(leaves, rows):
        flat_buf[off:off + leaf.numel()].copy_(leaf.reshape(-1))
        off += r * BLOCK
    return packed


def _compress_group(leaves: list[torch.Tensor], rows: list[int],
                    eps: float):
    """Pack ``leaves`` (:func:`_pack`) and compress the buffer in one fused
    dispatch; the buffer is freed on return."""
    return _compress_packed(_pack(leaves, rows), rows, eps)


def spectral_compress_tree(state: PyTree, eps: float = 1e-2,
                           policy: Optional[Callable[[str], bool]] = None, *,
                           fused: bool = True) -> PyTree:
    """Device stage of the hybrid checkpoint pipeline: lossy-compress every
    leaf ``policy(keystr)`` selects; other leaves pass through untouched.

    Returns the same tree structure with ``Compressed`` leaves where the
    policy fired. ``fused`` (default) packs the selected leaves into flat
    blocked buffers of at most :data:`GROUP_BYTES` f32 bytes each (a
    larger leaf is a buffer of its own) and
    compresses each buffer in a single fused dispatch, one after the
    other; ``fused=False`` takes the per-leaf single-tensor path.
    Thresholds are per leaf, so the grouping changes no bit of q or
    scale (a test holds this). Each leaf is zero-padded only to a
    multiple of the histogram tile — the JAX package's further pow2
    bucketing exists for its trace cache, which the port has no use for;
    zero pad blocks carry no energy, so the thresholds, q and scales are
    the same bits either way (a test holds this) — and the pad blocks past
    the tile multiple are never made.
    """
    flat = pytree.flatten_with_path(state)
    keys = [pytree.keystr(p) for p, _ in flat]
    new_leaves = {k: leaf for k, (_, leaf) in zip(keys, flat)}
    selected = [i for i, k in enumerate(keys)
                if policy is not None and policy(k)]
    if fused and len(selected) > 1:
        leaves = [flat[i][1] for i in selected]
        rows = []
        for leaf in leaves:
            nb = -(-leaf.numel() // BLOCK)
            rows.append(nb + (-nb) % K.HIST_TILE)
        for group in _groups(rows, GROUP_BYTES):
            g_rows = [rows[j] for j in group]
            q, scale = _compress_group([leaves[j] for j in group], g_rows,
                                       float(eps))
            off = 0
            for j, r in zip(group, g_rows):
                leaf = leaves[j]
                new_leaves[keys[selected[j]]] = Compressed(
                    q[off:off + r], scale[off:off + r], int(leaf.numel()),
                    tuple(leaf.shape), leaf.dtype)
                off += r
    else:
        for i in selected:
            new_leaves[keys[i]] = spectral_compress(flat[i][1], eps)
    return pytree.unflatten_like(state, new_leaves, "compressed state")


# ---------------------------------------------------------------------------
# In-graph variant (the JAX package compiles it into the train step)
# ---------------------------------------------------------------------------

def compress_in_graph(x: torch.Tensor, eps: float = 1e-2):
    """Returns (q: int8 (nb, B), scale: f32 (nb,)), the single-tensor codec
    on plain tensors, where ``x`` lives."""
    q, scale, _ = _compress_blocks(x, eps)
    return q, scale
