"""Serve a small model with batched requests + in-situ serving analytics
(PyTorch/CUDA port; JAX-free, on the card by default).

    python3 examples/torch_serve_insitu.py --requests 8 [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.serve import serve_loop  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--insitu", default="async",
                    choices=["sync", "async", "hybrid"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    out = serve_loop(args.arch, n_requests=args.requests,
                     max_new=args.max_new, insitu_mode=args.insitu,
                     device=args.device)
    for r in out["requests"][:4]:
        print(f"request {r.rid}: {r.out}")


if __name__ == "__main__":
    main()
