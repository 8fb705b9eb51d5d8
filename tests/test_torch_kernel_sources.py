"""What can be checked of the port's CUDA sources without a compiler, and
of the scripts that drive them on the card.

* Every ``ctypes`` signature a wrapper sets is an ``extern "C"`` entry of
  its source with the same parameters, one for one: a pointer or the
  stream as ``c_void_p``, ``int`` as ``c_int``, ``float`` as ``c_float``
  (a wrong count or type only shows on the card, as a crash or garbage).
* The card scripts (``chip_smoke.py``, ``tools/torch_*_split.py``) import
  neither JAX nor the JAX package: the machine with the card has no JAX.
* What each kernel's source and wrapper may and may not do (the coarse
  pair, the inverse and the refine kernel: which bodies they run, what
  scratch they take, which host steps a call makes).
"""
import ast
import ctypes
import hashlib
import inspect
import re
from pathlib import Path

import pytest

from repro_torch.kernels import paged_attention as PK
from repro_torch.kernels import spectral_lossy as K

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
_C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float,
            "size_t": ctypes.c_size_t}


def _entries(source: str) -> dict[str, tuple[str, list]]:
    """name -> (return type, parameter ctypes) of each ``extern "C"``
    function of a source."""
    text = source[source.index('extern "C" {'):]
    out = {}
    for m in re.finditer(r"^(int|size_t) (\w+)\(([^)]*)\) \{", text,
                         re.MULTILINE):
        params = []
        for p in filter(None, (q.strip() for q in m.group(3).split(","))):
            if "*" in p:
                params.append(ctypes.c_void_p)
            else:
                params.append(_C_TYPES[p.rsplit(" ", 1)[0]])
        out[m.group(2)] = (m.group(1), params)
    return out


@pytest.mark.parametrize("source, signatures", [
    ("spectral_lossy.cu", K._SIGNATURES),
    ("paged_attention.cu", PK._SIGNATURES),
])
def test_every_ctypes_signature_matches_its_c_entry(source, signatures):
    entries = _entries((CSRC / source).read_text())
    for name, (args, res) in signatures.items():
        assert name in entries, f"{name} is not an extern C entry of {source}"
        ret, params = entries[name]
        assert params == list(args), name
        assert _C_TYPES[ret] is res, name


def test_the_coarse_pair_runs_the_pipelined_body_alone():
    src = (CSRC / "spectral_lossy.cu").read_text()
    assert "bool dct_rows(" not in src
    for kernel in ("dct_coarse_tiled_kernel", "dct_coarse_range_kernel",
                   "dct_flat_tiled_kernel", "dct_flat_range_kernel"):
        body = src[src.index(f"{kernel}("):]
        body = body[:body.index("\n}\n")]
        assert "dct_rows_pipe(" in body, kernel
    assert "reduce_rows_kernel<kCoarse>" not in src
    assert "atomicAdd(" not in src.split("The coarse 32-bin pair")[1]


def test_the_inverse_runs_the_pipelined_body_and_the_old_one_is_gone():
    src = (CSRC / "spectral_lossy.cu").read_text()
    for gone in ("gemm_rows(", "kPanel ", "kPanelBytes", "kDctSmem"):
        assert gone not in src, gone
    body = src[src.index("dequant_idct_kernel("):]
    body = body[:body.index("\n}\n")]
    assert "gemm_rows_pipe(" in body and "issue_panel(" in body


def _body(src: str, head: str) -> str:
    body = src[src.index(head):]
    return body[:body.index("\n}\n")]


def test_hist_refine_is_one_pass_with_no_tile_rows():
    """``spectral_hist_refine`` launches the range kernel and its total,
    no ``reduce_rows_kernel`` (gone), and takes no per-tile rows: its
    scratch is the partial rows of at most kMaxParts ranges."""
    src = (CSRC / "spectral_lossy.cu").read_text()
    assert "reduce_rows_kernel" not in src
    entry = _body(src, "int spectral_hist_refine(")
    assert "refine_range_kernel<" in entry and "refine_total_kernel<<<" in entry
    assert "cnt_rows" not in entry and "hist_refine_kernel" not in entry
    assert "spectral_hist_refine_tiled(" not in entry
    parts = _body(src, "size_t spectral_hist_refine_parts_bytes(")
    assert "kMaxParts * kFine" in parts
    # the range kernel decides candidates on the bits and bins only the
    # candidates, compacted 32 to a round (bin_index is in refine_members)
    kernel = _body(src, "refine_range_kernel(const float*")
    assert "bin_index(" not in kernel
    assert kernel.index("refine_candidate(") < kernel.index("__ballot_sync(")
    assert "refine_members(q + qn, 32," in kernel
    members = _body(src, "__device__ __forceinline__ void refine_members(")
    assert "bin_index(" in members and "atomicAdd(" in members
    assert "float* __restrict__ cnt" not in kernel


def test_hist_refine_wrapper_makes_few_host_steps():
    """On the card: one allocation, the coarse bin passed as it is (no
    per-block copy), no read of a device value on the host."""
    src = inspect.getsource(K.hist_refine)
    card = src[src.index("_kernel_tile("):]
    for gone in ("_per_block(", ".contiguous(", "expand(", ".item(",
                 ".tolist(", ".cpu(", "synchronize("):
        assert gone not in card, gone
    assert card.count("torch.empty(") == 1 and "_launch(" in card
    arg = inspect.getsource(K._coarse_arg)
    for gone in (".item(", ".tolist(", ".cpu(", "synchronize(", "expand("):
        assert gone not in arg, gone


def test_kernel_3_is_the_text_it_was():
    """``hist_refine_tiled``'s kernel and entry keep the text they had
    beside the old single-tensor refine kernel (these hashes), so its
    tile rows keep their bits: the one-pass design is kernel 7's alone."""
    src = (CSRC / "spectral_lossy.cu").read_text()
    digest = {head: hashlib.sha256(_body(src, head).encode()).hexdigest()
              for head in ("__global__ void __launch_bounds__(kRefineThreads)"
                           "\nhist_refine_kernel(",
                           "int spectral_hist_refine_tiled(")}
    assert list(digest.values()) == [
        "37a3fd00343f4add3d438b3f0c56a5929297db15b731516b5d62b44a8eb389ea",
        "9426255d3f82e606503d7ccf322257f08c6f14a990cb84d530f64c30c7d5f81c"]
    for name in ("kRefineWarps = 8", "kRefineThreads = kRefineWarps * 32",
                 "kRs = kRefineThreads + 1"):
        assert f"constexpr int {name};" in src


@pytest.mark.parametrize("script", ["chip_smoke.py",
                                    "tools/torch_flat_split.py",
                                    "tools/torch_coarse_split.py",
                                    "tools/torch_paged_split.py",
                                    "tools/torch_refine_split.py"])
def test_card_scripts_import_no_jax(script):
    tree = ast.parse((ROOT / script).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    bad = sorted(n for n in names if n.split(".")[0] in ("jax", "repro"))
    assert not bad, bad
