"""Public entry points of the spectral lossy codec.

``spectral_compress_tree(state, eps, policy)`` is the device stage of the
hybrid checkpoint pipeline: every leaf the policy selects is compressed in
ONE fused dispatch over a packed buffer, through the four ported kernels
(:mod:`repro_torch.kernels.spectral_lossy`) on a CUDA state and through
their plain versions on a CPU state. ``spectral_decompress`` is restore's
device stage (the dequantise + inverse DCT kernel).

The single-tensor path (``spectral_compress``, its chunked variant and
``compress_in_graph``) would need the single-tensor kernels, which are
not ported yet: it runs the oracle on CPU tensors and raises
``NotImplementedError`` on CUDA ones (ROADMAP.md, queue 2).

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


def _oracle_quantized(xb: torch.Tensor, eps: float):
    """The flat-histogram oracle on padded blocks (the CPU path of the
    single-tensor codec, as the JAX package's off-TPU path)."""
    y = ref.dct_blocks(xb)
    _, energies = ref.energy_histogram(y)
    t = ref.threshold_from_histogram(energies, eps)
    return ref.quantize_blocks(y, t)


def spectral_compress(x: torch.Tensor, eps: float = 1e-2) -> Compressed:
    """Lossy-compress one tensor. Relative-L2 error <~ eps + quant.

    CPU tensors only for now (see the module docstring)."""
    if x.device.type != "cpu":
        raise K.not_ported("spectral_compress")
    xb, n = ref.blockize(x)
    q, scale = _oracle_quantized(_pad_blocks(xb, K.HIST_TILE), float(eps))
    return Compressed(q, scale, n, tuple(x.shape), x.dtype)


def spectral_compress_chunked(x: torch.Tensor, eps: float = 1e-2, *,
                              chunk_blocks: int = 4096):
    """``spectral_compress`` with the int8 coefficients split into
    ``chunk_blocks``-row pieces (4096 blocks x 256 B = the codec's 1 MiB
    frame chunk), so the host framing can pack chunk by chunk. Returns
    ``(chunks, scale, n_elements)``; ``cat(chunks)`` equals
    ``spectral_compress(x, eps).q``."""
    c = spectral_compress(x, eps)
    chunks = tuple(c.q[off:off + chunk_blocks]
                   for off in range(0, c.q.shape[0], chunk_blocks))
    return chunks, c.scale, c.n_elements


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


def spectral_compress_tree(state: PyTree, eps: float = 1e-2,
                           policy: Optional[Callable[[str], bool]] = None, *,
                           fused: bool = True) -> PyTree:
    """Device stage of the hybrid checkpoint pipeline: lossy-compress every
    leaf ``policy(keystr)`` selects; other leaves pass through untouched.

    Returns the same tree structure with ``Compressed`` leaves where the
    policy fired. ``fused`` (default) packs all selected leaves into one
    flat blocked buffer and compresses the whole tree in a single fused
    dispatch; ``fused=False`` takes the per-leaf single-tensor path (CPU
    only for now). Each leaf is zero-padded only to a multiple of the
    histogram tile — the JAX package's further pow2 bucketing exists for
    its trace cache, which the port has no use for; zero pad blocks carry
    no energy, so the thresholds, q and scales are the same bits either
    way (a test holds this) — and the pad blocks past the tile multiple
    are never made.
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
        dev = leaves[0].device
        # one f32 buffer, each leaf copied into its slice (the tails stay 0)
        packed = torch.zeros((sum(rows), BLOCK), dtype=torch.float32,
                             device=dev)
        flat_buf = packed.view(-1)
        off = 0
        for leaf, r in zip(leaves, rows):
            flat_buf[off:off + leaf.numel()].copy_(leaf.reshape(-1))
            off += r * BLOCK
        del flat_buf
        q, scale = _compress_packed(packed, rows, float(eps))
        del packed
        off = 0
        for i, leaf, r in zip(selected, leaves, rows):
            new_leaves[keys[i]] = Compressed(
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
    """Returns (q: int8 (nb, B), scale: f32 (nb,)). CPU tensors only for
    now: on a CUDA tensor it would need the single-tensor kernels."""
    if x.device.type != "cpu":
        raise K.not_ported("compress_in_graph")
    xb, _ = ref.blockize(x)
    return _oracle_quantized(_pad_blocks(xb, K.HIST_TILE), float(eps))
