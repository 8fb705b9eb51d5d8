"""Serving driver: batched-request serving with in-situ tasks attached.

Runs the paged continuous-batching engine on the card (``device="cuda"``,
the default) or, when the caller asks for it, on the CPU. The in-situ
session attaches the paper's pattern to the *serving* loop: periodic
serving-state snapshots published as a base+delta chain through the
versioned ``SnapshotStore`` while the device keeps decoding (the slab is
append-mostly, so deltas push the effective ratio far past plain zlib).

``smoke=True`` (the default) serves the architecture's reduced config;
``smoke=False`` its published widths, with random weights from ``seed``.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs import base as configs
from repro_torch.core import InSituPlan, Session, Telemetry
from repro_torch.core.host import resolve_device
from repro_torch.models import params as P_lib
from repro_torch.models import transformer
from repro_torch.serving.engine import Request
from repro_torch.serving.pages import PagedServingEngine


def default_serve_plan(*, insitu_mode: str = "async",
                       snapshot_every: int = 4, base_every: int = 8,
                       codec: str = "zlib",
                       snapshot_dir: Optional[str] = None,
                       p_i: int = 2) -> dict:
    """The serving loop's declarative in-situ plan (plain-dict form).

    One stream — ``kv_pages``, the live KV cache slab — with the
    ``serve_snapshot`` preset attached best-effort: drop on a full ring,
    never stall the decode loop. Snapshots go through the versioned
    delta store: every ``base_every``-th publish is a self-contained base
    frame, the rest delta-encode against the previous snapshot, and
    firings where the engine version is unchanged collapse to a no-op
    frame. ``snapshot_dir`` persists the chain crash-safely on disk
    (default: in-memory probe).
    """
    options: dict = {"base_every": base_every, "codec": codec}
    if snapshot_dir is not None:
        options["directory"] = snapshot_dir
    return {
        "streams": ["kv_pages"],
        "workers": p_i,
        "tasks": {
            "kv_snapshot": {"stream": "kv_pages", "preset": "serve_snapshot",
                            "every": snapshot_every,
                            "placement": insitu_mode,
                            "backpressure": "drop",
                            "options": options},
        },
    }


def serve_loop(arch: str, *, n_requests: int = 8, max_new: int = 8,
               slots: int = 4, insitu_mode: str = "async",
               seed: int = 0, plan: Optional[Any] = None,
               engine_kind: str = "paged", num_pages: int = 17,
               page_size: int = 16, prefix_len: int = 0, log=print,
               device: str | torch.device = "cuda",
               smoke: bool = True, cuda_graph: bool = True) -> dict:
    """Serve ``n_requests`` with the in-situ plan attached.

    ``prefix_len > 0`` gives every request a common ``prefix_len``-token
    system prompt, registered on the paged engine so matching admits map
    the shared chain copy-on-write and prefill only their own suffix.
    ``device`` defaults to the card and raises when CUDA is missing;
    ``smoke`` picks the reduced config (True) or the published widths.
    On CUDA each decode step replays a CUDA graph of the step, captured
    as the engine is built; ``cuda_graph=False`` steps eagerly (the CPU
    always does).
    """
    dev = resolve_device(device)
    if engine_kind == "dense":
        raise NotImplementedError(
            "the dense fixed-slot ServingEngine is not ported yet "
            "(ROADMAP.md: left waiting by the serving slice)")
    if engine_kind != "paged":
        raise ValueError(f"unknown engine kind {engine_kind!r}")
    cfg = configs.get(arch, smoke=smoke)
    gen = torch.Generator().manual_seed(seed)
    params = P_lib.materialize(gen, transformer.param_spec(cfg), dev)
    prompt_len = max(16, prefix_len + 8)
    max_len = max(64, ((prompt_len + max_new + page_size - 1)
                       // page_size) * page_size)
    # continuous batching over the shared page pool — same KV budget as
    # `slots` dense stripes ((num_pages-1) * page_size tokens) but
    # admission is per-page, so short requests stop blocking.
    engine = PagedServingEngine(cfg, params, num_pages=num_pages,
                                page_size=page_size, max_reqs=2 * slots,
                                prompt_len=prompt_len, max_len=max_len,
                                device=dev, cuda_graph=cuda_graph)
    tm = Telemetry()

    # serving-side in-situ declared as a plan, same shape as training
    if plan is None:
        plan = default_serve_plan(insitu_mode=insitu_mode)
    if not isinstance(plan, InSituPlan):
        plan = InSituPlan.from_dict(plan)

    rng = np.random.default_rng(seed)
    if prefix_len > 0:
        # shared system prompt + a short per-request unique tail
        prefix = rng.integers(0, cfg.vocab_size, size=prefix_len)
        requests = [
            Request(i, np.concatenate(
                [prefix, rng.integers(0, cfg.vocab_size, size=4)]),
                max_new=max_new)
            for i in range(n_requests)]
        if prefix_len >= engine.page_size:
            engine.register_prefix(prefix)
    else:
        requests = [
            Request(i, rng.integers(0, cfg.vocab_size, size=16),
                    max_new=max_new)
            for i in range(n_requests)]

    pending = list(requests)
    step = 0
    t0 = time.perf_counter()
    with Session(plan, telemetry=tm, raise_on_error=True) as session:
        while pending or any(a is not None for a in engine.active):
            with tm.span("serve/admit", step=step):   # eager prefill
                while pending and engine.admit(pending[0]):
                    pending.pop(0)
            if any(a is not None for a in engine.active):
                with session.step_span(step):
                    engine.step()
                if "kv_pages" in session.streams:
                    session.emit("kv_pages", step,
                                 lambda: engine.snapshot_payload())
            step += 1
            if step > 10000:
                break
    total = time.perf_counter() - t0
    done = sum(1 for r in requests if r.done)
    toks = sum(len(r.out) for r in requests)
    rep = session.report()
    ps = engine.page_stats()
    log(f"page pool: {ps['used_pages']}/{ps['num_pages'] - 1} pages "
        f"in use at exit, {ps['active_requests']} active rows")
    prefix_stats = engine.prefix_stats()
    log(f"prefix sharing: {prefix_stats['prefixes']} prefix(es) "
        f"({prefix_stats['prefix_pages']} pages), "
        f"hit rate {prefix_stats['hit_rate']:.0%} "
        f"({prefix_stats['hits']} hit / {prefix_stats['misses']} miss), "
        f"{prefix_stats['shared_pages']} shared pages now, "
        f"{prefix_stats['pages_saved']} pages saved by sharing, "
        f"{prefix_stats['shared_tokens']} prompt tokens served from "
        f"shared pages vs {prefix_stats['prefill_tokens']} prefilled")
    snap = rep["tasks"].get("kv_snapshot", {})
    if snap.get("publishes"):
        log(f"snapshots: {snap['publishes']} published "
            f"({snap['bases']} base / {snap['deltas']} delta / "
            f"{snap['noops']} noop), "
            f"effective compression {snap['effective_compression_x']:.1f}x, "
            f"chain depth {snap['chain_depth']}")
    log(f"served {done}/{len(requests)} requests, {toks} tokens "
        f"in {total:.2f}s ({toks / max(total, 1e-9):.1f} tok/s), "
        f"insitu results={rep['n_results']}, "
        f"handoff dispatch={rep['handoff_dispatch_s'] * 1e3:.2f}ms "
        f"(materialize {rep['handoff_materialize_s'] * 1e3:.2f}ms overlapped)")
    return {"requests": requests, "telemetry": tm, "steps": step,
            "insitu_results": len(session.results),
            "session_report": rep, "tok_per_s": toks / total,
            "prefix_stats": prefix_stats, "hydrate_info": None}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m",
                    choices=list(configs.ARCH_IDS))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--insitu", default="async",
                    choices=["sync", "async", "hybrid"])
    ap.add_argument("--num-pages", type=int, default=17,
                    help="page-pool size incl. the reserved scratch page")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (must divide max_len)")
    ap.add_argument("--snapshot-base-every", type=int, default=8,
                    help="full base frame every N snapshot publishes")
    ap.add_argument("--snapshot-dir", default=None,
                    help="persist the snapshot chain to this directory")
    ap.add_argument("--prefix-len", type=int, default=0,
                    help="give every request a common system prompt of "
                         "this many tokens, registered for COW sharing")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: the card)")
    ap.add_argument("--full", action="store_true",
                    help="serve the published widths instead of the "
                         "reduced smoke config")
    args = ap.parse_args()
    plan = default_serve_plan(insitu_mode=args.insitu,
                              base_every=args.snapshot_base_every,
                              snapshot_dir=args.snapshot_dir)
    serve_loop(args.arch, n_requests=args.requests, max_new=args.max_new,
               insitu_mode=args.insitu, plan=plan,
               num_pages=args.num_pages, page_size=args.page_size,
               prefix_len=args.prefix_len, device=args.device,
               smoke=not args.full)


if __name__ == "__main__":
    main()
