"""Quickstart (PyTorch/CUDA port): the declarative in-situ API in 60 lines.

Runs a tiny CUDA "simulation" (a training step stand-in: ``tanh(x @ w)``
eight times a step), declares the same compression probe under the
paper's three placements, and prints the telemetry the paper reads off
NSight: sync stalls the loop, async hides the work behind the device,
hybrid runs a device stage (the spectral kernels) that ships 4-8x less
data across the device->host boundary.

The workflow is *declared* as an ``InSituPlan`` (streams + triggers +
tasks) and driven through a ``Session`` — the application's only in-situ
call is ``session.emit``. JAX-free; runs on the card by default::

    python3 examples/torch_quickstart.py [--device cpu]
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import codecs, host  # noqa: E402
from repro_torch.insitu import (Every, InSituPlan, Placement,  # noqa: E402
                                Session, TaskSpec)
from repro_torch.kernels import ops  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    dev = host.resolve_device(args.device)

    # the "application": any device step
    w = torch.as_tensor(np.random.default_rng(0).standard_normal((512, 512)),
                        dtype=torch.float32, device=dev)

    def sim_step(x):
        for _ in range(8):
            x = torch.tanh(x @ w)
        return x

    def compress(step, payload):
        blob, st = codecs.encode(np.asarray(payload), "zlib")
        return st.ratio

    # hybrid's deeply-coupled device stage: lossy-compress ON DEVICE so the
    # hand-off ships the small int8 residue (the NEKO pattern)
    def device_lossy(step, x):
        return ops.spectral_compress(x, 1e-2).q

    for mode in (Placement.SYNC, Placement.ASYNC, Placement.HYBRID):
        plan = InSituPlan(
            streams=["field"],
            tasks=[TaskSpec(
                name="compress", stream="field", trigger=Every(2),
                placement=mode, sink=compress,
                device_stage=device_lossy if mode is Placement.HYBRID
                else None)],
            workers=2)
        state = torch.ones((512, 512), dtype=torch.float32, device=dev)
        t0 = time.perf_counter()
        with Session(plan, raise_on_error=True) as session:
            for i in range(10):
                with session.step_span(i):
                    state = sim_step(state)
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                session.emit("field", i, lambda: state)
        wall = time.perf_counter() - t0
        rep = session.report()
        print(f"{mode.value:6s}: wall={wall:.3f}s "
              f"stall={rep['sync_stall_s']:.3f}s "
              f"overlapped={rep['async_overlapped_s']:.3f}s "
              f"handoff={rep['handoff_s']:.4f}s "
              f"results={rep['n_results']}")


if __name__ == "__main__":
    main()
