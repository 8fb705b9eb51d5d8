"""The paper's compression story on training state, end to end (PyTorch/
CUDA port).

Shows (1) Table II: plain lossless barely compresses float tensors,
(2) §IV-B: spectral lossy + lossless removes ~98% on smooth fields with a
hard error bound (the spectral kernels on the card), (3) the
checkpoint-manager integration: lossy moments + lossless weights, written
asynchronously with the HYBRID device stage, restored. JAX-free; runs on
the card by default::

    python3 examples/torch_compression_demo.py [--device cpu]
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import optim  # noqa: E402
from repro_torch.core import codecs, host  # noqa: E402
from repro_torch.insitu import InSituPlan, Session  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    dev = host.resolve_device(args.device)
    rng = np.random.default_rng(0)

    print("== Table II analog: lossless CR on float data ==")
    t = np.linspace(0, 40, 1 << 18)
    field = (np.sin(t) + 0.3 * np.sin(7.3 * t)
             + 0.01 * rng.standard_normal(t.size)).astype(np.float32)
    for codec in ("zlib", "bz2", "lzma"):
        cr = codecs.compression_ratio(field, codec).ratio
        print(f"  {codec:5s}: CR = {cr * 100:5.2f}%  (paper: 1.5-10%)")

    print("\n== §IV-B: spectral lossy + lossless at eps=1e-2 ==")
    x = torch.as_tensor(field, device=dev)
    c = ops.spectral_compress(x, 1e-2)
    xh = ops.spectral_decompress(c)
    q = c.q.cpu().numpy()
    blob, _ = codecs.encode(q, "zlib")
    stored = len(blob) + int(c.scale.cpu().numpy().nbytes)
    print(f"  removed {(field.nbytes - stored) / field.nbytes * 100:.2f}% "
          f"(paper: ~98%), rel-L2 error {ref.rel_l2_error(x, xh):.4f}, "
          f"kept coeffs {ref.kept_fraction(c) * 100:.2f}%")

    print("\n== checkpoint integration (hybrid in-situ) ==")
    params = {"w": torch.as_tensor(rng.standard_normal((512, 256)),
                                   dtype=torch.float32, device=dev)
              .to(torch.bfloat16)}
    st = optim.init(params, optim.AdamWConfig())
    state = {"params": params, "mu": st.mu, "nu": st.nu}
    with tempfile.TemporaryDirectory() as d:
        plan = InSituPlan.from_dict({
            "streams": ["train_state"],
            "tasks": {"checkpoint": {"stream": "train_state",
                                     "preset": "checkpoint",
                                     "placement": "hybrid", "every": 1,
                                     "options": {"directory": d,
                                                 "device": dev.type}}},
        })
        with Session(plan, raise_on_error=True) as session:
            session.emit("train_state", 100, lambda: state)
        rep = session.checkpoint.reports[-1]
        print(f"  checkpoint: {rep.raw_bytes} B raw -> {rep.stored_bytes} B "
              f"stored (CR {rep.ratio * 100:.1f}%), "
              f"{rep.lossy_leaves}/{rep.n_leaves} leaves lossy")
        step, restored = session.restore(state)
    exact = bool(torch.equal(restored["params"]["w"], params["w"]))
    print(f"  restored step {step}: weights bit-exact = {exact}")


if __name__ == "__main__":
    main()
