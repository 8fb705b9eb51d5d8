"""Serving driver: batched-request serving with in-situ tasks attached.

Runs the paged continuous-batching engine (or the dense fixed-slot
baseline, ``engine_kind="dense"``) on the card (``device="cuda"``, the
default) or, when the caller asks for it, on the CPU. The in-situ
session attaches the paper's pattern to the *serving* loop: periodic
serving-state snapshots published as a base+delta chain through the
versioned ``SnapshotStore`` while the device keeps decoding (the slab is
append-mostly, so deltas push the effective ratio far past plain zlib).
``snapshot_to`` streams that chain to a live consumer over ``tcp://``, and
``hydrate_from`` brings a replica up from such a chain instead of cold.

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
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.pages import PagedServingEngine


def default_serve_plan(*, insitu_mode: str = "async",
                       snapshot_every: int = 4, base_every: int = 8,
                       codec: str = "zlib",
                       snapshot_dir: Optional[str] = None,
                       snapshot_to: Optional[str] = None,
                       p_i: int = 2) -> dict:
    """The serving loop's declarative in-situ plan (plain-dict form).

    One stream — ``kv_pages``, the live KV cache slab — with the
    ``serve_snapshot`` preset attached best-effort: drop on a full ring,
    never stall the decode loop. Snapshots go through the versioned
    delta store: every ``base_every``-th publish is a self-contained base
    frame, the rest delta-encode against the previous snapshot, and
    firings where the engine version is unchanged collapse to a no-op
    frame. ``snapshot_dir`` persists the chain crash-safely on disk
    (default: in-memory probe). ``snapshot_to`` additionally streams every
    raw chain frame to a transport URL (``tcp://host:port`` of a
    ``repro_torch.launch.consume`` consumer or a replica hydrator) — the
    remote replica tails the delta chain live and can restore
    bit-identically while this loop keeps serving.
    """
    options: dict = {"base_every": base_every, "codec": codec}
    if snapshot_dir is not None:
        options["directory"] = snapshot_dir
    if snapshot_to is not None:
        options["to"] = snapshot_to
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


def weight_generator(cfg, seed: int, device: torch.device,
                     smoke: bool) -> torch.Generator:
    """The generator ``serve_loop`` draws its random weights from: the
    card's for a full-width MoE, hybrid or ssm (xLSTM) model on the card
    (GBs, drawn in seconds there and in minutes on the host), the CPU's
    for every other config (whose bits the port's other callers draw the
    same way)."""
    on_card = (cfg.family in ("moe", "hybrid", "ssm") and not smoke
               and device.type == "cuda")
    return torch.Generator(device if on_card else "cpu").manual_seed(seed)


def serve_loop(arch: str, *, n_requests: int = 8, max_new: int = 8,
               slots: int = 4, insitu_mode: str = "async",
               seed: int = 0, plan: Optional[Any] = None,
               engine_kind: str = "paged", num_pages: int = 17,
               page_size: int = 16, prefix_len: int = 0,
               hydrate_from: Optional[Any] = None, log=print,
               device: str | torch.device = "cuda",
               smoke: bool = True, cuda_graph: bool = True) -> dict:
    """Serve ``n_requests`` with the in-situ plan attached.

    ``prefix_len > 0`` gives every request a common ``prefix_len``-token
    system prompt, registered on the paged engine so matching admits map
    the shared chain copy-on-write and prefill only their own suffix (the
    families with per-row recurrent state, hybrid and ssm, refuse it, as
    in the JAX package).
    ``hydrate_from`` (a chain directory, ``tcp://host:port`` listen
    address, or ``SnapshotStore``) skips cold start entirely: the paged
    engine is rebuilt from the snapshot chain — pool, tables, allocator,
    prefixes, in-flight requests — and keeps serving from there.
    ``engine_kind="dense"`` serves on the fixed-slot baseline instead.
    ``device`` defaults to the card and raises when CUDA is missing;
    ``smoke`` picks the reduced config (True) or the published widths;
    the weights come from ``seed`` through :func:`weight_generator`.
    On CUDA each decode step replays a CUDA graph of the step, captured
    as the engine is built; ``cuda_graph=False`` steps eagerly (the CPU
    always does).
    """
    dev = resolve_device(device)
    cfg = configs.get(arch, smoke=smoke)
    params = P_lib.materialize(weight_generator(cfg, seed, dev, smoke),
                               transformer.param_spec(cfg), dev)
    hydrate_info = None
    prompt_len = max(16, prefix_len + 8)
    max_len = max(64, ((prompt_len + max_new + page_size - 1)
                       // page_size) * page_size)
    if engine_kind == "paged":
        if hydrate_from is not None:
            from repro_torch.launch.hydrate import ReplicaHydrator

            # a cold replica usually starts BEFORE the producer has
            # published anything — give the producer's warm-up (weights,
            # graph capture) a grace window before the first frame, then
            # a generous idle timeout between frames
            engine, hydrate_info = ReplicaHydrator(hydrate_from).hydrate(
                cfg, params, idle_timeout_s=30.0, start_grace_s=120.0,
                device=dev, cuda_graph=cuda_graph, log=log)
        else:
            # continuous batching over the shared page pool — same KV
            # budget as `slots` dense stripes ((num_pages-1) * page_size
            # tokens) but admission is per-page, so short requests stop
            # blocking.
            engine = PagedServingEngine(cfg, params, num_pages=num_pages,
                                        page_size=page_size,
                                        max_reqs=2 * slots,
                                        prompt_len=prompt_len,
                                        max_len=max_len, device=dev,
                                        cuda_graph=cuda_graph)
    elif engine_kind == "dense":
        if hydrate_from is not None:
            raise ValueError("hydration needs the paged engine "
                             "(engine_kind='paged')")
        # parity / benchmark baseline: fixed dense slots
        engine = ServingEngine(cfg, params, slots=slots,
                               prompt_len=prompt_len, max_len=max_len,
                               device=dev, cuda_graph=cuda_graph)
    else:
        raise ValueError(f"unknown engine kind {engine_kind!r}")
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
        if engine_kind == "paged" and prefix_len >= engine.page_size:
            engine.register_prefix(prefix)
    else:
        requests = [
            Request(i, rng.integers(0, cfg.vocab_size, size=16),
                    max_new=max_new)
            for i in range(n_requests)]

    # a hydrated engine carries the producer's in-flight requests — they
    # drain through the same loop and count toward the serve totals, but
    # tokens the producer already generated (in req.out at hydration
    # time) are not this replica's work and stay out of its tok/s
    pending = list(requests)
    carried_toks = 0
    if hydrate_info is not None:
        carried = [a for a in engine.active if a is not None]
        carried_toks = sum(len(r.out) for r in carried)
        requests = carried + requests
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
    toks = sum(len(r.out) for r in requests) - carried_toks
    rep = session.report()
    prefix_stats = None
    if engine_kind == "paged":
        ps = engine.page_stats()
        log(f"page pool: {ps['used_pages']}/{ps['num_pages'] - 1} pages "
            f"in use at exit, {ps['active_requests']} active rows")
        prefix_stats = engine.prefix_stats()
        log(f"prefix sharing: {prefix_stats['prefixes']} prefix(es) "
            f"({prefix_stats['prefix_pages']} pages), "
            f"hit rate {prefix_stats['hit_rate']:.0%} "
            f"({prefix_stats['hits']} hit / {prefix_stats['misses']} "
            f"miss), {prefix_stats['shared_pages']} shared pages now, "
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
            "prefix_stats": prefix_stats, "hydrate_info": hydrate_info}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m",
                    choices=list(configs.ARCH_IDS))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--insitu", default="async",
                    choices=["sync", "async", "hybrid"])
    ap.add_argument("--engine", default="paged",
                    choices=["paged", "dense"],
                    help="paged = continuous batching over a shared page "
                         "pool (default); dense = fixed-slot baseline")
    ap.add_argument("--num-pages", type=int, default=17,
                    help="page-pool size incl. the reserved scratch page")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (must divide max_len)")
    ap.add_argument("--snapshot-base-every", type=int, default=8,
                    help="full base frame every N snapshot publishes")
    ap.add_argument("--snapshot-dir", default=None,
                    help="persist the snapshot chain to this directory")
    ap.add_argument("--snapshot-to", default=None,
                    help="stream the snapshot chain to a transport URL "
                         "(tcp://host:port of a live consumer)")
    ap.add_argument("--prefix-len", type=int, default=0,
                    help="give every request a common system prompt of "
                         "this many tokens, registered for COW sharing "
                         "on the paged engine")
    ap.add_argument("--hydrate-from", default=None,
                    help="bring the paged engine up from a snapshot "
                         "chain instead of cold: a chain directory, or a "
                         "tcp://host:port address to listen on for a "
                         "producer's mirrored frames")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: the card)")
    ap.add_argument("--full", action="store_true",
                    help="serve the published widths instead of the "
                         "reduced smoke config")
    args = ap.parse_args()
    plan = default_serve_plan(insitu_mode=args.insitu,
                              base_every=args.snapshot_base_every,
                              snapshot_dir=args.snapshot_dir,
                              snapshot_to=args.snapshot_to)
    serve_loop(args.arch, n_requests=args.requests, max_new=args.max_new,
               insitu_mode=args.insitu, plan=plan,
               engine_kind=args.engine, num_pages=args.num_pages,
               page_size=args.page_size, prefix_len=args.prefix_len,
               hydrate_from=args.hydrate_from, device=args.device,
               smoke=not args.full)


if __name__ == "__main__":
    main()
