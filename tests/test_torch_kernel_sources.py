"""What can be checked of the port's CUDA sources without a compiler, and
of the scripts that drive them on the card.

* Every ``ctypes`` signature a wrapper sets is an ``extern "C"`` entry of
  its source with the same parameters, one for one: a pointer or the
  stream as ``c_void_p``, ``int`` as ``c_int``, ``float`` as ``c_float``
  (a wrong count or type only shows on the card, as a crash or garbage).
* The card scripts (``chip_smoke.py``, ``tools/torch_*_split.py``) import
  neither JAX nor the JAX package: the machine with the card has no JAX.
"""
import ast
import ctypes
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


@pytest.mark.parametrize("script", ["chip_smoke.py",
                                    "tools/torch_flat_split.py",
                                    "tools/torch_coarse_split.py",
                                    "tools/torch_paged_split.py"])
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
