"""The port's ``RPLY`` lossy frames against the JAX package's, on the CPU.

Frames are compared byte for byte: the header (dtype token, shape, sizes)
and the lossless-coded q and scale. The two packages compute the same DCT
rows at these sizes, the same thresholds and the same scales (the JAX
codec runs compiled, where ``amax / 127.0`` is ``amax * f32(1/127)``,
which the port computes). Decoded tensors agree to rtol/atol 1e-5 x the
data's scale: the inverse DCT is a matrix product summed in two orders.
"""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import lossy as JL
from repro_torch.core import compression, host
from repro_torch.core import lossy as TL

SRC = Path(__file__).resolve().parents[1] / "src"


def _payload(n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 40, n)
    x = (np.sin(t) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    x = x.reshape(-1, 100) if n % 100 == 0 else x
    if dtype == "bfloat16":
        return x.astype(ml_dtypes.bfloat16)
    return x


def _port_input(x):
    """The same values as a port tensor (bf16 through its bit pattern)."""
    return host.to_tensor(x, "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,stream", [(40000, False), (40000, True),
                                      (1_100_000, None)])
def test_compress_tensor_frames_byte_identical(dtype, n, stream):
    x = _payload(n, dtype)
    j_blob, j_st = JL.compress_tensor(x, 1e-2, "zlib", stream=stream)
    t_blob, t_st = TL.compress_tensor(_port_input(x), 1e-2, "zlib",
                                      stream=stream, device="cpu")
    assert t_blob == j_blob
    assert (t_st.raw_bytes, t_st.stored_bytes) == (j_st.raw_bytes,
                                                   j_st.stored_bytes)
    assert t_st.kept_fraction == pytest.approx(j_st.kept_fraction)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_each_package_decodes_the_others_frames(dtype):
    x = _payload(40000, dtype, seed=1)
    j_blob, _ = JL.compress_tensor(x, 1e-2)
    t_blob, _ = TL.compress_tensor(_port_input(x), 1e-2, device="cpu")
    want = np.asarray(JL.decompress_tensor(j_blob)).astype(np.float32)
    from_jax = TL.decompress_tensor(j_blob, device="cpu")
    from_port = np.asarray(JL.decompress_tensor(t_blob)).astype(np.float32)
    assert from_jax.dtype == (torch.bfloat16 if dtype == "bfloat16"
                              else torch.float32)
    assert tuple(from_jax.shape) == x.shape
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(from_jax.float().numpy(), want,
                               rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_array_equal(from_port, want)      # identical frames
    err = TL.ref.rel_l2_error(torch.from_numpy(x.astype(np.float32)),
                              from_jax.float())
    assert err <= TL.error_bound(1e-2)


_NO_ML_DTYPES = r"""
import sys
from repro_torch.core import lossy
blob = open(sys.argv[1], "rb").read()
t = lossy.decompress_tensor(blob, device="cpu")
print(t.dtype, tuple(t.shape), "ml_dtypes" in sys.modules)
"""


def test_bf16_frames_decode_without_ml_dtypes(tmp_path):
    blob, _ = JL.compress_tensor(_payload(40000, "bfloat16"), 1e-2)
    path = tmp_path / "frame.bin"
    path.write_bytes(blob)
    out = subprocess.run([sys.executable, "-c", _NO_ML_DTYPES, str(path)],
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"},
                         check=True).stdout.split()
    assert out == ["torch.bfloat16", "(400,", "100)", "False"]


def test_measure_reports_error_within_bound():
    x = _payload(40000, "float32", seed=2)
    _, st = TL.compress_tensor(torch.from_numpy(x), 1e-2, measure=True,
                               device="cpu")
    _, jst = JL.compress_tensor(x, 1e-2, measure=True)
    assert st.rel_l2_error <= TL.error_bound(1e-2)
    assert st.rel_l2_error == pytest.approx(jst.rel_l2_error, rel=1e-3)


def test_tree_roundtrip_and_registry_codec():
    rng = np.random.default_rng(3)
    tree = {"params": {"w": torch.from_numpy(
                rng.standard_normal((64, 32)).astype(np.float32))},
            "opt": {"mu": torch.from_numpy(
                rng.standard_normal((64, 32)).astype(np.float32)
            ).to(torch.bfloat16)}}
    blobs, stats = TL.compress_tree(tree, 1e-2, device="cpu")
    assert blobs["['opt']['mu']"][:4] == TL.LOSSY_MAGIC
    assert blobs["['params']['w']"][:4] != TL.LOSSY_MAGIC
    back = TL.restore_tree(tree, blobs, device="cpu")
    assert torch.equal(back["params"]["w"], tree["params"]["w"])
    assert back["opt"]["mu"].dtype == torch.bfloat16
    assert TL.ref.rel_l2_error(tree["opt"]["mu"], back["opt"]["mu"]) \
        <= TL.error_bound(1e-2)
    # the registry carries the lossy codecs; their work runs on the card
    # by default, so a CPU run names its device
    assert {"spectral", "spectral-coarse"} <= set(
        compression.available(lossy=True))
    assert compression.get("spectral").device == "cuda"
    codec = TL.SpectralLossyCodec(eps=1e-2, device="cpu")
    arr = rng.standard_normal(5000).astype(np.float32)
    out = codec.decode(codec.encode(arr))
    assert out.shape == arr.shape
    assert TL.ref.rel_l2_error(torch.from_numpy(arr), torch.from_numpy(out)) \
        <= codec.error_bound()
