"""One family's ``train_loop`` on the card: eager, graphed with a save, resumed

    python3 tools/torch_family_train.py [--arch xlstm-1.3b] [--eager-steps 1]
        [--graph-steps 2] [--ckpt-dir build/family_ckpt]
    python3 tools/torch_family_train.py --arch hymba-1.5b --scan-remat-peak
    python3 tools/torch_family_train.py --slstm-nodes

Runs ``launch/train.py::train_loop(arch, smoke=False, device="cuda")`` at
``FULL_SHAPE`` (4 x 4096 tokens) and full depth, from seed 0 on the
card's generator, three times:

1. eagerly (``cuda_graph=False``), ``--eager-steps`` steps, no in-situ
   task;
2. graphed, ``--graph-steps`` steps, with a HYBRID checkpoint task that
   saves at step 0 only (``every`` past the run) under ``--ckpt-dir``,
   frames stored raw (``lossless="none"``: zlib would add minutes a save
   at these sizes), a SYNC probe that keeps the state emitted at step 0
   on the host (the moments as arrays, every other leaf as a sha256 of
   its bits, taken one leaf at a time: a full host copy of xlstm-1.3b's
   48 blocks beside the save's host stages passed the chip machine's 96
   GiB), and a SYNC profiler window around the last replay (opened
   after the save at the step before, closed when the last step's
   ``grads`` are emitted);
3. graphed again on the same directory: it must log "resumed from step
   0"; the restored state is held against the probe's on the card
   (params and count bitwise; each moment leaf within ``error_bound(1e-2)``
   relative L2, or, for a leaf whose energy is below the selectors'
   absolute slack of 1e-30 — both packages may drop such a leaf whole —
   an error norm within 1e-15), then one step runs.

Gates (a broken one exits 1): every loss finite; the graphed losses equal
the eager ones bit for bit over the steps both ran; the save launches each
of kernels 2-4 (``dct_hist_coarse_tiled``, ``hist_refine_tiled``,
``threshold_quant``) once a packed group (``ops.GROUP_BYTES``) and kernel
5 (``dequant_idct``) not at all; the restore launches kernel 5 once a
moment leaf; no other checkpoint kernel runs, and the eager run without a
save launches none; the sLSTM cell's kernels run in every run of an
xLSTM arch on the card (forward and backward) and in no other (launch
counts set to 0 before each run and read after; on the CPU, where the
plain versions run, every count is 0).

Prints one line ``FAMILY_TRAIN_RESULT {json}``: the card's name and power
limit, per run its losses, ``step/compute`` seconds and median, peak memory
(``max_memory_allocated``) and wall; the capture seconds (the loop's log
line, echoed, carries the graph's node count); the host's peak resident
memory by run; the profiled
replay's device busy ms, idle share and top ops; model FLOPs a step
(``roofline.model_flops``) over the median graphed step as a share of 989
TFLOP/s; the save's groups, launches, loop blocking, raw and stored bytes;
the restore's launches, seconds and worst moment error; the host's
resident memory at the start and end of each stage of the save, of
the probe's stages and of the profiler window's (``save_stages``) and
its peak within each
(``host_rss_peak_by_phase_gib``). If the card runs
out of memory, the line carries ``"fault": "out of memory"``, the peak
and the op (the innermost frame of the port and the allocator's message),
and the script exits 3; it does not shrink the run.

``--slstm-nodes`` instead captures one sLSTM layer's time loop at full
width (4 x 4096, bf16), forward and forward + backward, as the fused
``SLSTMScan`` and as the plain loop under autograd, and prints each
one's graph nodes and its share of a full-depth train step's graph
(``SLSTM_NODES {json}``).

``--scan-remat-peak`` instead takes one eager step of ``--arch`` with the
SSM scan's per-chunk remat and one without it, and prints each one's
seconds and peak memory, or where memory ran out (``SCAN_REMAT_PEAK
{json}``; exit 1 if the step with the remat does not fit). It is the
measurement that ``models/ssm.py``'s per-chunk remat rests on (PERF.md
section 5): run it again when the scan changes, to see whether the remat
is still needed.

``chip_smoke.py``'s ``family_train`` phase calls :func:`run`
(``hymba-1.5b`` and ``xlstm-1.3b`` cut in depth through :func:`config_as`,
the MoE archs at their smoke configs) with a ``kernel_check`` that holds
kernels 2-5 against their plain versions on the save's own packed
buffers; its other phases take :func:`check_restored`,
:func:`ckpt_blocking_s`, :func:`launches` / :func:`reset_launches` and
:func:`config_as` from here too (one definition of each). Needs the
card; imports no JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import traceback

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

EPS = 1e-2                      # the checkpoint's lossy_eps
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


@contextlib.contextmanager
def config_as(arch: str, cfg):
    """``configs.get(arch, smoke=False)`` returns ``cfg`` inside the block
    (a depth cut for ``train_loop``, which takes a name, not a config)."""
    from repro_torch.configs import base as configs

    get = configs.get

    def patched(name, smoke=False):
        return cfg if name == arch and not smoke else get(name, smoke=smoke)

    configs.get = patched
    try:
        yield cfg
    finally:
        configs.get = get


def lossy_layout(cfg) -> tuple[list[str], list[int], list[list[int]]]:
    """The moment leaves of a HYBRID save of ``cfg``'s state as
    ``ops.spectral_compress_tree`` packs them: their keys and blocks (tile
    multiples) in flatten order, and the packed groups (indices into
    both) under ``ops.GROUP_BYTES``."""
    from repro_torch.checkpoint.manager import default_lossy_policy
    from repro_torch.core import pytree
    from repro_torch.kernels import ops
    from repro_torch.kernels import spectral_lossy as K
    from repro_torch.models import transformer

    spec = transformer.param_spec(cfg)
    keys, rows = [], []
    for path, s in pytree.flatten_with_path({"mu": spec, "nu": spec}):
        if default_lossy_policy(pytree.keystr(path)):
            nb = -(-math.prod(s.shape) // 256)
            keys.append(pytree.keystr(path))
            rows.append(nb + (-nb) % K.HIST_TILE)
    return keys, rows, ops._groups(rows, ops.GROUP_BYTES)


def checked_groups(rows: list[int], groups: list[list[int]]) -> dict:
    """The groups whose packed buffers the kernels are held against their
    plain versions on, by label: the largest group within
    ``ops.GROUP_BYTES``, and the largest leaf past it (a group of its
    own), each where there is one."""
    from repro_torch.kernels import ops

    blocks = lambda g: sum(rows[j] for j in g)
    past = lambda g: blocks(g) * ops.BLOCK * 4 > ops.GROUP_BYTES
    out = {}
    for label, gs in (("largest group", [g for g in groups if not past(g)]),
                      ("leaf past the bound", [g for g in groups
                                               if past(g)])):
        if gs:
            out[label] = max(gs, key=blocks)
    return out


#: the kernels of a model's own step (the xLSTM family's sLSTM cell): they
#: run in every step of that family, outside any checkpoint
MODEL_KERNELS = ("slstm_cell", "slstm_cell_bwd")


def launches() -> dict:
    """Every kernel wrapper's launch count, by name."""
    from repro_torch.kernels import paged_attention as PK
    from repro_torch.kernels import slstm as SK
    from repro_torch.kernels import spectral_lossy as K

    out = {k.__name__: k.launches for k in K.KERNELS}
    out["paged_decode_attention"] = PK.paged_decode_attention.launches
    out.update({k.__name__: k.launches for k in SK.KERNELS})
    return out


def reset_launches() -> None:
    from repro_torch.kernels import paged_attention as PK
    from repro_torch.kernels import slstm as SK
    from repro_torch.kernels import spectral_lossy as K

    K.reset_launches()
    SK.reset_launches()
    PK.paged_decode_attention.launches = 0


def ckpt_launches(got: dict) -> dict:
    """``got`` without the model's own kernels (:data:`MODEL_KERNELS`)."""
    return {k: n for k, n in got.items() if k not in MODEL_KERNELS}


#: the selectors keep a leaf's dropped energy within eps^2 of its energy
#: plus an absolute 1e-30 (``ref.select_coarse``, as in the JAX package),
#: so a leaf of energy below 1e-30 may restore as zeros: its error norm
#: stays within sqrt(1e-30)
ENERGY_SLACK_NORM = 1e-15


def check_restored(restored, emitted: dict, what: str) -> dict:
    """A restored state against the host copy emitted at its step, on the
    card (a leaf kept as a :func:`_digest` against its digest): params and
    count bitwise; each moment leaf's error norm within
    ``error_bound(EPS)`` of its norm plus :data:`ENERGY_SLACK_NORM`.
    Returns the worst relative error among the leaves of energy above
    the slack and the keys of those below it."""
    import numpy as np
    import torch
    from repro_torch.core import host, pytree
    from repro_torch.kernels import ref

    worst, below = 0.0, []
    bound = ref.error_bound(EPS)
    for path, t in pytree.flatten_with_path(restored):
        key = pytree.keystr(path)
        if isinstance(emitted[key], str):           # a digest (_Digested)
            if _digest(t) != emitted[key]:
                raise AssertionError(f"{what}: restored {key} differs from "
                                     f"the state emitted at its step")
            continue
        want = host.to_tensor(np.asarray(emitted[key])).to(t.device)
        if key.startswith("['mu']") or key.startswith("['nu']"):
            w, got = want.float().reshape(-1), t.float().reshape(-1)
            norm = float(torch.linalg.vector_norm(w))
            err = float(torch.linalg.vector_norm(w - got))
            if not err <= bound * norm + ENERGY_SLACK_NORM:
                raise AssertionError(
                    f"{what}: {key} error norm {err} past {bound} x "
                    f"{norm} + {ENERGY_SLACK_NORM} (max |w| "
                    f"{float(w.abs().max())}, max |got| "
                    f"{float(got.abs().max())})")
            if norm ** 2 > 1e-30:
                worst = max(worst, err / norm)
            else:
                below.append(key)
        else:
            same = (want.dtype == t.dtype and want.shape == t.shape
                    and torch.equal(want.view(torch.uint8)
                                    if want.dim() else want,
                                    t.view(torch.uint8) if t.dim() else t))
            if not same:
                raise AssertionError(f"{what}: restored {key} differs from "
                                     f"the state emitted at its step")
        del want
    return {"worst_rel_l2": worst, "below_energy_slack": below}


def _digest(t) -> str:
    """sha256 of a tensor's dtype, shape and bits (one leaf's host copy
    at a time)."""
    import hashlib
    from repro_torch.core import host

    h = hashlib.sha256(f"{t.dtype} {tuple(t.shape)}".encode())
    h.update(host.to_numpy(t.detach().cpu()).tobytes())
    return h.hexdigest()


class _Digested:
    """A train state as the probe keeps it: each moment leaf as a pageable
    host array, every other leaf as :func:`_digest`; the hand-off passes
    it through untouched (it copies tensor leaves only)."""

    def __init__(self, state):
        from repro_torch.core import host, pytree

        self.leaves = {}
        for path, t in pytree.flatten_with_path(state):
            key = pytree.keystr(path)
            self.leaves[key] = (host.to_numpy(t.cpu())
                                if key.startswith(("['mu']", "['nu']"))
                                else _digest(t))


class _RssWatch:
    """A thread that samples this process's resident host memory twice a
    second and prints a line, with the current phase, each time it first
    passes a multiple of ``step_gib``; ``peak`` holds the largest sample
    by phase."""

    def __init__(self, say, step_gib: float = 8.0):
        import threading

        self.say, self.step = say, step_gib
        self.phase, self.peak, self.mark = "start", {}, 0.0
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self) -> None:
        while not self.stop.wait(0.5):
            rss = _rss_gib()["VmRSS"]
            self.peak[self.phase] = max(self.peak.get(self.phase, 0.0), rss)
            if rss >= self.mark + self.step:
                self.mark = rss - rss % self.step
                self.say(f"host RSS {rss} GiB ({self.phase})")

    def close(self) -> dict:
        self.stop.set()
        self.thread.join()
        return self.peak


class _SaveStages:
    """Host memory through a checkpoint save's stages: within the block,
    each stage of ``CheckpointManager`` (the HYBRID device stage, the
    hand-off to host, the encode fan-out's split, items and gather, the
    sink) and each named call of :meth:`timed` records this process's
    resident memory as it starts and ends, and sets ``watch``'s phase
    (where given) to it meanwhile, so the watch's peak by phase is the
    peak sampled within it (stages on several workers at once share the
    label of the last to start). ``rows``: per stage, calls, seconds, the first
    start's RSS and the highest end's (GiB)."""

    STAGES = ("_device_lossy", "_handoff", "_encode_split",
              "_encode_leaf_item", "_encode_gather", "_encode_stage",
              "_write_sink")

    def __init__(self, watch=None):
        self.watch, self.rows, self._orig = watch, {}, {}

    def timed(self, name: str, fn, *args, **kwargs):
        before, t0 = _rss_gib()["VmRSS"], time.perf_counter()
        phase = self.watch.phase if self.watch is not None else None
        if self.watch is not None:
            self.watch.phase = f"save {name}"
        try:
            return fn(*args, **kwargs)
        finally:
            if self.watch is not None:
                self.watch.phase = phase
            row = self.rows.setdefault(name, {"calls": 0, "s": 0.0,
                                              "rss_in_gib": before,
                                              "rss_out_gib": 0.0})
            row["calls"] += 1
            row["s"] += time.perf_counter() - t0
            row["rss_out_gib"] = max(row["rss_out_gib"],
                                     _rss_gib()["VmRSS"])

    def __enter__(self):
        from repro_torch.checkpoint.manager import CheckpointManager

        for name in self.STAGES:
            fn = self._orig[name] = getattr(CheckpointManager, name)
            setattr(CheckpointManager, name,
                    lambda mgr, *a, _n=name.strip("_"), _f=fn, **kw:
                    self.timed(_n, _f, mgr, *a, **kw))
        return self

    def __exit__(self, *exc) -> None:
        from repro_torch.checkpoint.manager import CheckpointManager

        for name, fn in self._orig.items():
            setattr(CheckpointManager, name, fn)


def _rss_gib() -> dict:
    """This process's resident and peak resident host memory, GiB."""
    out = {}
    with open("/proc/self/status") as f:
        for ln in f:
            key = ln.split(":")[0]
            if key in ("VmRSS", "VmHWM"):
                out[key] = round(int(ln.split()[1]) / 2**20, 2)
    return out


def _profile_ops(prof) -> dict:
    """Device ms by kernel (or copy) name over a profiler window, summed
    from its raw events: ``key_averages`` takes ~30 s over the ~10^5
    events of a replay at these widths, this well under one."""
    from torch.autograd import DeviceType

    ops: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            ops[e.name()] = ops.get(e.name(), 0.0) + e.duration_ns() / 1e6
    return ops


def _capture_s(lines: list) -> list:
    return [float(m.group(1)) for m in
            (re.match(r"captured the train step in ([\d.]+)s", ln)
             for ln in lines) if m]


def ckpt_blocking_s(tm, first_save: bool = False) -> float:
    """Seconds the checkpoint task held the loop: its SYNC chain, its
    device stage (HYBRID), its hand-off dispatch and any blocking
    hand-off. ``first_save`` counts only the save at step 0 (the spans
    before step 1's compute), which carries the one-time costs."""
    end = math.inf
    if first_save:
        end = next(sp.t0 for sp in tm.spans("step/compute") if sp.step == 1)
    return sum(sp.dt for sp in tm.spans()
               if sp.t0 < end
               and (sp.name in ("insitu-sync/checkpoint",
                                "insitu-device/checkpoint")
                    or (sp.name in ("handoff/dispatch", "step/handoff")
                        and sp.meta.get("task") == "checkpoint")))


def _sync(device: str) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _peak_gib(device: str):
    import torch

    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated() / 2**30


def _run_row(run: dict, t0: float, lines: list, device: str) -> dict:
    import numpy as np

    _sync(device)
    row = {"losses": run["losses"], "wall_s": time.perf_counter() - t0,
           "peak_gib": _peak_gib(device),
           "step_s": [sp.dt for sp in run["telemetry"].spans("step/compute")],
           "capture_s": _capture_s(lines)}
    row["step_median_s"] = statistics.median(row["step_s"])
    if not np.isfinite(run["losses"]).all():
        raise AssertionError(f"non-finite losses {run['losses']}")
    if run["session_report"]["n_errors"]:
        raise AssertionError(run["session_report"]["errors"])
    return row


def _free(device: str) -> None:
    import gc
    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # the pinned host buffers a run's hand-offs left in the pinned
        # allocator's cache (tens of GB at full-width xlstm-1.3b)
        host_empty = getattr(torch._C, "_host_emptyCache", None)
        if host_empty is not None:
            host_empty()


def run(arch: str, *, eager_steps: int, graph_steps: int, ckpt_dir: str,
        smoke: bool = False, save_eager: bool = False,
        resume_graph: bool = True, kernel_check=None, log=print,
        tag: str = "", device: str = "cuda") -> dict:
    """The three runs and their gates (module docstring) for ``arch`` as
    ``configs.get(arch, smoke=smoke)`` gives it (wrap the call in
    :func:`config_as` to cut it; ``smoke`` runs the smoke config at the
    smoke shape). ``save_eager`` gives the eager run the same HYBRID save
    at step 0 (its own directory, the same launch gates);
    ``resume_graph=False`` takes the resumed step eagerly (no second
    capture). ``kernel_check(xb, rows, label)``, where given, is called
    after the resume on the packed f32 buffer (``ops._pack``) of the
    save's largest group and of its largest leaf past ``ops.GROUP_BYTES``
    (:func:`checked_groups`), built from the moments emitted at step 0:
    the buffers kernels 2-4 compressed in the save, for the caller to
    hold kernels 2-5 against their plain versions on (``chip_smoke.py``'s
    ``spectral_check``); its launches are not the path's (counts set to
    0 after), its results come back under ``"kernel_check"``. Returns the
    result dict; raises AssertionError on a gate. ``device="cpu"``
    rehearses the runs on the CPU (every step eager, no profile of the
    device)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import base as configs
    from repro_torch.core import host, pytree
    from repro_torch.core.session import (Every, InSituPlan, Placement,
                                          TaskSpec, When)
    from repro_torch.kernels import ops
    from repro_torch.launch import train as T
    from repro_torch.models import params as P_lib
    from repro_torch.models import transformer
    from repro_torch.roofline.analysis import PEAK_FLOPS_BF16, model_flops

    if graph_steps < 2:
        raise ValueError("graph_steps must be >= 2: the profiled replay "
                         "follows the step-0 save")
    cfg = configs.get(arch, smoke=smoke)
    tag = tag or arch
    say = lambda m: log(f"{tag}: {m}")
    keys, rows, groups = lossy_layout(cfg)
    n_lossy, n_groups = len(keys), len(groups)
    to_check = checked_groups(rows, groups) if kernel_check else {}
    kept: dict = {}                     # the checked groups' moments
    eager_dir = ckpt_dir + "_eager"
    for d in (ckpt_dir, eager_dir):
        if os.path.exists(d):
            shutil.rmtree(d)
    runs: dict = {}
    total: dict = {}                    # launches over the three runs
    model_runs: dict = {}               # the sLSTM cell's, per run

    def echo(lines: list):
        """The loop's log: kept for the parsers, and shown."""
        return lambda m: (lines.append(m), say(f"loop: {m}"))

    def count_launches(what: str, backward: bool = True) -> dict:
        """This run's launches, added to the total; checks the sLSTM
        cell ran in every step of an xLSTM run on the card (its backward
        in a train step) and nowhere else. Returns the checkpoint's."""
        got = launches()
        for k, n in got.items():
            total[k] = total.get(k, 0) + n
        model = {k: got[k] for k in MODEL_KERNELS}
        slstm = on_card and cfg.family == "ssm"
        if (model["slstm_cell"] > 0) != slstm or (
                model["slstm_cell_bwd"] > 0) != (slstm and backward):
            raise AssertionError(f"{what}: sLSTM launches {model}")
        model_runs[what] = model
        return ckpt_launches(got)

    def ckpt_task(directory, trigger):
        return TaskSpec(name="checkpoint", stream="train_state",
                        preset="checkpoint", trigger=trigger,
                        placement=Placement.HYBRID,
                        options={"directory": directory, "device": device,
                                 "lossless": "none"})

    def check_save(what, ck, got):
        if ck["saves"] != 1 or ck["last_step"] != 0:
            raise AssertionError(f"{what}: saves {ck}")
        for k, n in got.items():
            want = n_groups if on_card and k in (
                "dct_hist_coarse_tiled", "hist_refine_tiled",
                "threshold_quant") else 0
            if n != want:
                raise AssertionError(f"{what}: save launches {got}: {k} "
                                     f"{n} != {want} ({n_groups} groups)")

    on_card = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if on_card else [])

    # 1. eager: no in-situ task, or the same save as the graphed run's
    _free(device)
    rss = _RssWatch(say) if on_card else None
    reset_launches()
    lines: list = []
    t0 = time.perf_counter()
    out = T.train_loop(arch, smoke=smoke, steps=eager_steps,
                       plan=InSituPlan(
                           streams=["grads", "train_state"],
                           tasks=[ckpt_task(eager_dir,
                                            Every(eager_steps + 1))]
                           if save_eager else []),
                       device=device, seed=0, cuda_graph=False,
                       log=echo(lines))
    runs["eager"] = _run_row(out, t0, lines, device)
    got = count_launches("eager")
    if save_eager:
        check_save("eager", out["session_report"]["checkpoint"], got)
        runs["eager"]["save_launches"] = got
        shutil.rmtree(eager_dir, ignore_errors=True)
    elif any(got.values()):
        raise AssertionError(f"eager run launches {got}")
    del out
    say(f"eager: losses {runs['eager']['losses']}, step/compute s "
        f"{runs['eager']['step_s']}, peak {runs['eager']['peak_gib']} GiB")

    # 2. graphed, one HYBRID save at step 0, a probe, a profiler window
    emitted: dict = {}
    window: dict = {}
    last = graph_steps - 1
    stages = _SaveStages(rss)

    def keep(step, payload):
        emitted.update(payload.leaves)
        say(f"probe at step {step}: host RSS {_rss_gib()}")

    def open_window(step, _payload):
        _sync(device)
        window["prof"] = profile(activities=activities)
        window["prof"].start()
        window["t0"] = time.perf_counter()

    def close_window(step, _payload):
        _sync(device)
        window["wall_s"] = time.perf_counter() - window["t0"]
        window["prof"].stop()

    plan = InSituPlan(streams=["grads", "train_state"], tasks=[
        ckpt_task(ckpt_dir, Every(graph_steps + 1)),
        # not through the hand-off's pinned buffers (the whole state,
        # 21.6 GB at xlstm-1.3b's 48 blocks, beside the save's): params
        # and count as digests of their bits, the moments copied leaf by
        # leaf into pageable host memory
        TaskSpec(name="probe", stream="train_state", trigger=When(
            lambda st: st == 0), placement=Placement.SYNC,
            sink=lambda step, pl: stages.timed("probe sink", keep, step,
                                               pl),
            device_stage=lambda step, st: stages.timed("probe", _Digested,
                                                       st)),
        TaskSpec(name="window_open", stream="train_state", trigger=When(
            lambda st: st == last - 1), placement=Placement.SYNC,
            sink=lambda step, pl: stages.timed("window open", open_window,
                                               step, pl)),
        TaskSpec(name="window_close", stream="grads", trigger=When(
            lambda st: st == last), placement=Placement.SYNC,
            sink=lambda step, pl: stages.timed("window close",
                                               close_window, step, pl))])
    _free(device)
    reset_launches()
    lines = []
    if rss is not None:
        rss.phase = "graphed"
    t0 = time.perf_counter()
    with stages:
        out = T.train_loop(arch, smoke=smoke, steps=graph_steps, plan=plan,
                           device=device, seed=0, cuda_graph=True,
                           log=echo(lines))
    runs["graph"] = g = _run_row(out, t0, lines, device)
    g["save_stages"] = stages.rows
    if rss is not None:
        g["host_rss_peak_by_phase_gib"] = dict(rss.peak)
    save_launches = count_launches("graph")
    g["host_rss_gib"] = _rss_gib()
    ck = out["session_report"]["checkpoint"]
    g["save_blocking_s"] = ckpt_blocking_s(out["telemetry"])
    del out
    dev_ops = stages.timed("profile read", _profile_ops,
                           window.pop("prof"))
    busy = sum(dev_ops.values())
    wall_ms = window["wall_s"] * 1e3
    g.update(profiled_wall_ms=wall_ms,
             device_busy_ms=busy if dev_ops else None,
             device_idle_share=(1 - busy / wall_ms) if dev_ops else None,
             top=sorted(dev_ops.items(), key=lambda kv: -kv[1])[:6])
    if len(g["capture_s"]) != int(on_card):
        raise AssertionError(f"captures {g['capture_s']}: {lines}")
    n = min(eager_steps, graph_steps)
    if g["losses"][:n] != runs["eager"]["losses"][:n]:
        raise AssertionError(f"graphed losses {g['losses']} != eager "
                             f"{runs['eager']['losses']}")
    check_save("graphed", ck, save_launches)
    save = {"groups": n_groups, "moment_leaves": n_lossy,
            "launches": save_launches, "raw_bytes": ck["raw_bytes"],
            "stored_bytes": ck["stored_bytes"],
            "blocking_s": g["save_blocking_s"]}
    for name, row in stages.rows.items():
        say(f"save stage {name}: {row}")
    say(f"graphed: losses {g['losses']} (= eager bit for bit), capture "
        f"{g['capture_s']} s, step/compute s {g['step_s']}, peak "
        f"{g['peak_gib']} GiB; the save: {n_groups} groups of "
        f"{n_lossy} moment leaves, launches {save_launches}, loop blocking "
        f"{save['blocking_s']:.3f} s, {ck['raw_bytes']} -> "
        f"{ck['stored_bytes']} bytes; replay profiled: busy "
        f"{g['device_busy_ms']} ms of {wall_ms:.1f}, idle share "
        f"{g['device_idle_share']}")
    for op, ms in g["top"]:
        say(f"  {ms:9.2f} ms  {op[:90]}")

    # 3. resume from the save: the restored state against the probe's
    restore: dict = {}

    def on_session(session):
        inner = session.restore

        def checked(template, step=None, **kw):
            t0 = time.perf_counter()
            start, state = inner(template, step, **kw)
            _sync(device)
            restore["restore_s"] = time.perf_counter() - t0
            restore["launches"] = ckpt_launches(launches())
            restore.update(check_restored(state, emitted,
                                          f"{tag} step {start}"))
            kept.update({keys[j]: emitted[keys[j]]
                         for g in to_check.values() for j in g})
            emitted.clear()
            return start, state

        session.restore = checked

    resume_plan = InSituPlan(streams=["grads", "train_state"], tasks=[
        ckpt_task(ckpt_dir, When(lambda st: False))])
    _free(device)
    reset_launches()
    lines = []
    if rss is not None:
        rss.phase = "resume"
    t0 = time.perf_counter()
    out = T.train_loop(arch, smoke=smoke, steps=1, plan=resume_plan,
                       device=device, seed=0, cuda_graph=resume_graph,
                       log=echo(lines), on_session=on_session)
    runs["resume"] = _run_row(out, t0, lines, device)
    runs["resume"]["host_rss_gib"] = _rss_gib()
    del out
    if "resumed from step 0" not in lines:
        raise AssertionError(f"no 'resumed from step 0' in {lines}")
    want = {k: (n_lossy if on_card and k == "dequant_idct" else 0)
            for k in restore["launches"]}
    if restore["launches"] != want:
        raise AssertionError(f"restore launches {restore['launches']} != "
                             f"{want}")
    got = count_launches("resume")
    if got != want:
        raise AssertionError(f"resume run launches {got} != {want}")
    say(f"resumed from step 0: restore {restore['restore_s']:.2f} s, params "
        f"and count bitwise, moments worst rel L2 "
        f"{restore['worst_rel_l2']:.4e} (bound 7.30e-2; leaves of energy "
        f"below 1e-30: {restore['below_energy_slack']}), launches "
        f"{restore['launches']}; loss {runs['resume']['losses']}")

    # 4. kernels 2-5 against their plain versions on the save's buffers
    checks: dict = {}
    for label, grp in to_check.items():
        g_rows = [rows[j] for j in grp]
        xb = ops._pack([host.to_tensor(kept.pop(keys[j]), device)
                        for j in grp], g_rows)
        checks[label] = kernel_check(xb, g_rows, f"{tag} {label}")
        say(f"{label} ({len(grp)} leaves, {sum(g_rows)} blocks): kernels "
            f"against their plain versions {checks[label]}")
        del xb
        _free(device)
    reset_launches()

    shape = configs.SMOKE_SHAPE if smoke else T.FULL_SHAPE
    flops = model_flops(cfg, shape)
    share = flops / g["step_median_s"] / PEAK_FLOPS_BF16
    say(f"model FLOPs a step {flops:.4e} (roofline.model_flops at "
        f"{shape.global_batch} x {shape.seq_len}), over the graphed median "
        f"{g['step_median_s']:.4f} s: {share:.4f} of 989 TFLOP/s bf16")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    host_peak = rss.close() if rss is not None else None
    return {"arch": arch, "n_layers": cfg.n_layers,
            "host_rss_peak_gib": host_peak,
            "params": P_lib.param_count(transformer.param_spec(cfg)),
            "runs": runs, "save": save, "restore": restore,
            "launches": total, "model_launches": model_runs,
            "kernel_check": checks,
            "model_flops": flops, "model_flops_share_of_bf16_peak": share}


def scan_remat_peak(arch: str = "hymba-1.5b") -> dict:
    """One eager ``make_train_step`` of ``arch`` at ``FULL_SHAPE`` with the
    SSM scan's per-chunk remat and once without it (``ssm.checkpoint``
    replaced by a plain call): each step's seconds and peak memory, or
    the peak and the site where memory ran out."""
    import torch
    from repro_torch.configs import base as configs
    from repro_torch.data.pipeline import batch_spec_for, synth_batch
    from repro_torch.launch import train as T
    from repro_torch.models import params as P_lib
    from repro_torch.models import ssm

    cfg = configs.get(arch)
    dev = torch.device("cuda")
    state = T.init_state(cfg, P_lib.weight_generator(cfg, 0, dev, False),
                         T.StepConfig().opt, device=dev)
    host = synth_batch(batch_spec_for(cfg, T.FULL_SHAPE), 0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    fn = T.make_train_step(cfg, T.StepConfig())
    out = {"arch": arch, "state_gib": torch.cuda.memory_allocated() / 2**30}
    remat = ssm.checkpoint
    plain = lambda f, *args, **kw: f(*args)
    try:
        for name, ck in (("chunk_remat", remat), ("no_chunk_remat", plain)):
            ssm.checkpoint = ck
            _free("cuda")
            t0 = time.perf_counter()
            try:
                new, metrics = fn(state, batch)
                loss = float(metrics["loss"])
                torch.cuda.synchronize()
                out[name] = {"s": time.perf_counter() - t0, "loss": loss,
                             "peak_gib": _peak_gib("cuda")}
                del new, metrics
            except torch.cuda.OutOfMemoryError as e:
                out[name] = {"fault": "out of memory",
                             "op": _oom_site(e),
                             "message": str(e).splitlines()[0],
                             "peak_gib": _peak_gib("cuda")}
            print(f"{arch} {name}: {out[name]}", flush=True)
    finally:
        ssm.checkpoint = remat
    return out


def _capture_nodes(fn) -> int:
    """Nodes of ``fn()`` captured in a CUDA graph (after one eager call on
    a side stream, as ``core/graphs.py`` warms up)."""
    import torch
    from repro_torch.core.graphs import graph_nodes

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    n = graph_nodes(graph)
    del graph
    torch.cuda.synchronize()
    return n


def slstm_nodes(arch: str = "xlstm-1.3b") -> dict:
    """Graph nodes of one sLSTM layer's time loop at ``arch``'s full width
    and ``FULL_SHAPE`` (bf16), forward alone and forward + backward,
    captured as ``SLSTMScan`` and as the plain loop under autograd
    (``slstm_loop``: the loop the port ran before the cell kernels); and
    each form's share of a full-depth train step's graph: its sLSTM layers
    x (two forwards, the remat's recompute being the second, + one
    backward)."""
    import torch
    from repro_torch.configs import base as configs
    from repro_torch.launch import train as T
    from repro_torch.models import xlstm as X

    cfg = configs.get(arch)
    b, l = T.FULL_SHAPE.global_batch, T.FULL_SHAPE.seq_len
    d, nh = cfg.d_model, cfg.n_heads
    dh = d // nh
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    gx = torch.randn((b, l, 4 * d), generator=gen, device=dev)
    rg = (torch.randn((4, nh, dh, dh), generator=gen, device=dev)
          * dh ** -0.5).to(torch.bfloat16)
    z = torch.zeros((b, nh, dh), device=dev)
    h0 = z.to(torch.bfloat16)
    layers = cfg.n_layers // cfg.xlstm.slstm_every
    out: dict = {"layers": layers}
    for name in ("scan", "loop"):
        def run(grad: bool, name=name):
            g = gx.clone().requires_grad_(grad)
            r = X._recurrent_weights(rg.clone().requires_grad_(grad))
            if name == "scan":
                h = X.SLSTMScan.apply(g, r, z, z, z - 1e30, h0)[0]
            else:
                h = X.slstm_loop(cfg, g, r, {"c": z, "n": z, "m": z - 1e30,
                                             "h": h0})[0]
            if grad:
                torch.autograd.grad(h.float().sum(), [g, r])
        t0 = time.perf_counter()
        fwd = _capture_nodes(lambda: run(False))
        both = _capture_nodes(lambda: run(True))
        out[name] = {"forward": fwd, "forward_backward": both,
                     "train_step_share": layers * (fwd + both),
                     "capture_s": time.perf_counter() - t0}
        print(f"sLSTM nodes, {name}: {out[name]}", flush=True)
        _free("cuda")
    out["ratio"] = (out["scan"]["train_step_share"]
                    / out["loop"]["train_step_share"])
    return out


def _find_oom(exc: BaseException):
    """The out-of-memory error in ``exc``'s chain, or None: the
    allocator's, or the CUDA runtime's ``cudaErrorMemoryAllocation`` (a
    graph that does not instantiate at the end of its capture)."""
    import torch

    while exc is not None:
        if isinstance(exc, torch.cuda.OutOfMemoryError) or \
                "out of memory" in str(exc):
            return exc
        exc = exc.__cause__ or exc.__context__
    return None


def _oom_site(exc: BaseException) -> str:
    """The innermost frame of the port (or of this script) in a
    traceback: where the allocation that failed was asked for (or the
    capture that did not instantiate)."""
    frames = traceback.extract_tb(exc.__traceback__)
    mine = [f for f in frames if "repro_torch" in f.filename
            or f.filename.endswith("torch_family_train.py")]
    f = (mine or frames)[-1]
    return f"{os.path.relpath(f.filename, ROOT)}:{f.lineno} {f.line}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="xlstm-1.3b")
    ap.add_argument("--eager-steps", type=int, default=1)
    ap.add_argument("--graph-steps", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        ROOT, "build", "family_ckpt"))
    ap.add_argument("--slstm-nodes", action="store_true",
                    help="instead: the graph nodes of one sLSTM layer's "
                         "time loop, fused and plain (SLSTM_NODES {json})")
    ap.add_argument("--scan-remat-peak", action="store_true",
                    help="instead: one eager step of --arch with and "
                         "without the SSM scan's per-chunk remat, and "
                         "each one's peak memory (SCAN_REMAT_PEAK {json})")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_family_train: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result: dict = {"card": card()}
    print(result["card"], flush=True)
    if args.slstm_nodes:
        result.update(slstm_nodes(args.arch))
        print("SLSTM_NODES " + json.dumps(result), flush=True)
        return 0
    if args.scan_remat_peak:
        result.update(scan_remat_peak(args.arch))
        print("SCAN_REMAT_PEAK " + json.dumps(result), flush=True)
        return 0 if "peak_gib" in result["chunk_remat"] and \
            "fault" not in result["chunk_remat"] else 1
    t0 = time.perf_counter()
    try:
        result.update(run(args.arch, eager_steps=args.eager_steps,
                          graph_steps=args.graph_steps,
                          ckpt_dir=os.path.join(args.ckpt_dir, args.arch),
                          log=lambda m: print(m, flush=True)))
        rc = 0
    except RuntimeError as e:          # torch's OutOfMemoryError is one
        oom = _find_oom(e)
        if oom is None:
            raise
        free, total = torch.cuda.mem_get_info()
        result.update(fault="out of memory", op=_oom_site(oom),
                      message=str(oom).splitlines()[0],
                      peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                      reserved_gib=torch.cuda.memory_reserved() / 2**30,
                      free_gib=free / 2**30, total_gib=total / 2**30)
        rc = 3
    except AssertionError as e:
        result.update(fault="gate", message=str(e)[:2000])
        rc = 1
    result["wall_s"] = time.perf_counter() - t0
    print("FAMILY_TRAIN_RESULT " + json.dumps(result), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
