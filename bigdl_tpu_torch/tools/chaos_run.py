"""Chaos harness (the port's counterpart of ``scripts/chaos_run.py``): kill
a real training run at injected steps, restart it under the supervisor,
and hold the final parameters to an uninterrupted run's, bit for bit. It
covers the whole recovery path: the fault injector, a process death
(``os._exit``: nothing flushes), the newest checksum-valid pair's resume,
and the step-for-step replay.

    # 2 preemptions, equality asserted
    python -m bigdl_tpu_torch.tools.chaos_run --kills 2 --platform cpu

    # kill inside a checkpoint write too (a torn pair: resume falls back)
    python -m bigdl_tpu_torch.tools.chaos_run --kills 1 --kill-in-ckpt

    # elastic: lose 1 of 4 gloo ranks before step 5; the run must finish
    # at 3 ranks, its loss within --tolerance of the uninterrupted run's,
    # with the reshape in its cli.perf line and the fault log
    python -m bigdl_tpu_torch.tools.chaos_run --kill-device 1@5

The trainee (``--worker``, this module) is a small seeded model with
Dropout, so a resume that replayed the wrong seeds would diverge. It
checkpoints every ``--ckpt-every`` iterations; each restart resumes from
the newest valid pair. The parent is ``resilience.supervise_command``:
restart while the child dies with ``PREEMPT_RC`` (75), within a budget,
with deterministic backoff. Without ``--platform`` it runs on the card.

It prints one JSON line, ``{"equal": ..., "kills": [...], "restarts": N,
"fault_events": [...]}`` (the kill-device mode: ``checks`` and the
reshape), and exits non-zero on any mismatch or missing fault-log entry.

Stated difference: the kill-device mode runs 4 gloo ranks
(``parallel.launch.spawn``; on the card they share it) where the JAX
harness runs 8 virtual CPU devices in one process.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

N_RANKS = 4  # the kill-device mode's job


# ------------------------------------------------------------------ worker
def worker_main(args) -> int:
    """One training attempt: resume from the newest valid pair (if any),
    train to --max-it, write the final parameters to --out."""
    if args.faultPlan:
        from bigdl_tpu_torch.resilience.faults import install_plan, parse_plan
        install_plan(parse_plan(args.faultPlan),
                     log_path=args.faultLog or None)

    import numpy as np
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.core.module import Sequential
    from bigdl_tpu_torch.dataset import BatchDataSet
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger

    rs = np.random.RandomState(0)
    x = rs.randn(64, 8).astype(np.float32)
    y = rs.randint(0, 3, 64).astype(np.int32)
    g = torch.Generator().manual_seed(0)
    model = Sequential(nn.Linear(8, 16, generator=g), nn.ReLU(),
                       nn.Dropout(0.5), nn.Linear(16, 3, generator=g),
                       nn.LogSoftMax())
    ds = BatchDataSet(x, y, 16)  # 4 iterations an epoch
    opt = Optimizer(model, ds, nn.ClassNLLCriterion(),
                    optim_method=SGD(learning_rate=0.1),
                    end_when=Trigger.max_iteration(args.maxIt), seed=7,
                    log_every=100, device=args.platform)
    opt.set_checkpoint(Trigger.several_iteration(args.ckptEvery), args.ckpt)
    # a no-op on an empty directory; else the newest checksum-valid pair
    # (past torn or corrupt ones), or a model-only blob when a kill landed
    # between the model.<n> and state.<n> writes
    opt.resume(args.ckpt)
    trained = opt.optimize()
    np.savez(args.out, **{k: v.cpu().numpy()
                          for k, v in trained.params.items()})
    return 0


# ------------------------------------------------- elastic kill-device mode
def perf_rank(a: dict):
    """One rank of the kill-device mode's job (a ``parallel.launch.spawn``
    target): ``cli.perf`` with ``a["argv"]``; returns its line (without
    the losses) and its exit."""
    from bigdl_tpu_torch.cli import perf

    try:
        out = perf.main(a["argv"])
    except SystemExit as e:
        if e.code in (0, None):
            raise  # a rank lost to the re-formation leaves the job
        return {"exit": str(e.code)}
    return {k: v for k, v in out.items() if k != "losses"}


def _kill_device_mode(args, wd: str) -> int:
    """``--kill-device N@STEP``: ``cli.perf --strategy dp --elastic hold``
    over ``N_RANKS`` gloo ranks, the kill_device fault at STEP; the run
    must finish at the surviving count with its loss within --tolerance
    of an uninterrupted run's, the reshape in its line and the kill in
    the fault log."""
    from bigdl_tpu_torch.parallel.launch import spawn

    try:
        n_kill_s, _, step_s = args.killDevice.partition("@")
        n_kill, step = int(n_kill_s), int(step_s)
        if n_kill < 1 or step < 1:
            raise ValueError
    except ValueError:
        print(f"chaos: bad --kill-device {args.killDevice!r} "
              "(expected N@STEP, e.g. 1@5)", flush=True)
        return 2
    fault_log = os.path.join(wd, "faults.jsonl")
    base = ["-m", "lenet5", "-b", "16", "-i", str(args.maxIt),
            "--strategy", "dp",
            # constant data + f32: hold-padding duplicates identical rows,
            # so the loss after the reshape stays comparable
            "--dataType", "constant", "--f32"]
    if args.platform:
        base += ["--platform", args.platform]
    print(f"chaos: kill-device mode — lose {n_kill} of {N_RANKS} rank(s) "
          f"before step {step}, max_it={args.maxIt}, workdir={wd}",
          flush=True)

    def job(argv, tag):
        try:
            res = spawn("bigdl_tpu_torch.tools.chaos_run:perf_rank",
                        N_RANKS, {"argv": argv}, timeout_s=args.timeout,
                        backend="gloo", env={"BIGDL_FAULT_LOG": fault_log})
        except (RuntimeError, TimeoutError) as e:
            print(f"chaos: {tag} run failed: {e}", flush=True)
            return None, None
        return res[0], res

    ref, _ = job(base, "ref")
    if ref is None or "exit" in ref:
        return 2
    el, ranks = job(base + ["--elastic", "hold", "--minDevices",
                            str(args.minDevices), "--faultPlan",
                            f"kill_device@step:{step}:{n_kill}"], "elastic")
    if el is None or "exit" in el:
        print(f"chaos: elastic run gave {el}", flush=True)
        return 2
    kill_events = []
    if os.path.exists(fault_log):
        with open(fault_log) as f:
            kill_events = [e for e in (json.loads(ln) for ln in f
                                       if ln.strip())
                           if e.get("fault") == "kill_device"]
    surviving = N_RANKS - n_kill
    reshape = el.get("reshape")
    rel = (abs(el["final_loss"] - ref["final_loss"])
           / max(abs(ref["final_loss"]), 1e-9))
    checks = {
        "finished_at_surviving_count": el["n_devices"] == surviving,
        "lost_ranks_left": sum(r is None for r in ranks) == n_kill,
        "reshape_stamped": bool(
            reshape and reshape.get("from_devices") == N_RANKS
            and reshape.get("to_devices") == surviving
            and reshape.get("restore_ms") is not None),
        "kill_logged": len(kill_events) >= 1,
        "loss_within_tolerance": rel <= args.tolerance,
        "supervised_retry_recorded": bool(
            el.get("supervisor", {}).get("retries", 0) >= 1),
    }
    out = {"chaos": "kill_device_reshape", "kill": f"{n_kill}@{step}",
           "devices": {"before": N_RANKS, "after": el["n_devices"]},
           "reshape": reshape, "ref_loss": ref["final_loss"],
           "elastic_loss": el["final_loss"], "rel_loss_delta": round(rel, 6),
           "tolerance": args.tolerance, "fault_events": kill_events,
           "checks": checks}
    print(json.dumps(out), flush=True)
    if not all(checks.values()):
        failed = sorted(k for k, v in checks.items() if not v)
        print(f"chaos: FAILED ({', '.join(failed)})", flush=True)
        return 1
    print(f"chaos: OK — lost {n_kill} rank(s) at step {step}, run "
          f"finished at {surviving} ranks, loss delta {rel * 100:.2f}% <= "
          f"{args.tolerance * 100:.0f}%, reshape stamped in the perf line "
          "and the fault log", flush=True)
    return 0


# ------------------------------------------------------------------ parent
def _resumed_iteration(ckpt_dir: str) -> int:
    """The iteration ``Optimizer.resume`` picks (the newest valid pair,
    else a checksum-valid model-only blob), so the parent's visit numbers
    name the global step the worker resumes at."""
    from bigdl_tpu_torch.utils.file import (latest_checkpoint,
                                            latest_valid_checkpoint_pair,
                                            verify_checkpoint)
    m, _s = latest_valid_checkpoint_pair(ckpt_dir)
    if m is None:
        m = latest_checkpoint(ckpt_dir, "model.")
        if m is None or not verify_checkpoint(m):
            return 0
    tail = str(m).rstrip("/").rsplit(".", 1)[-1]
    return int(tail) if tail.isdigit() else 0


def _worker_argv(args, ckpt: str, out: str, plan: str = "",
                 fault_log: str = "") -> list:
    argv = [sys.executable, "-m", "bigdl_tpu_torch.tools.chaos_run",
            "--worker", "--max-it", str(args.maxIt), "--ckpt-every",
            str(args.ckptEvery), "--ckpt", ckpt, "--out", out]
    if args.platform:
        argv += ["--platform", args.platform]
    if plan:
        argv += ["--faultPlan", plan]
    if fault_log:
        argv += ["--faultLog", fault_log]
    return argv


def main(argv=None) -> int:
    p = argparse.ArgumentParser("python -m bigdl_tpu_torch.tools.chaos_run")
    p.add_argument("--worker", action="store_true",
                   help="internal: run one training attempt")
    p.add_argument("--kills", type=int, default=2,
                   help="process-fatal preemptions to inject at evenly "
                        "spaced steps")
    p.add_argument("--kill-steps", default=None,
                   help="explicit comma-separated global kill steps "
                        "(overrides --kills spacing)")
    p.add_argument("--kill-in-ckpt", action="store_true",
                   help="also preempt INSIDE a checkpoint write on the "
                        "first attempt (torn pair -> previous-pair "
                        "fallback)")
    p.add_argument("--max-it", dest="maxIt", type=int, default=12)
    p.add_argument("--ckpt-every", dest="ckptEvery", type=int, default=3)
    p.add_argument("--budget", type=int, default=8,
                   help="restart budget for the supervising parent")
    p.add_argument("--kill-device", dest="killDevice", nargs="?",
                   const="1@5", default=None, metavar="N@STEP",
                   help=f"elastic mode: lose N of {N_RANKS} gloo ranks at "
                        "STEP and assert the run finishes on the survivors "
                        "with the reshape stamped (default 1@5)")
    p.add_argument("--tolerance", type=float, default=0.05,
                   help="kill-device mode: max relative final-loss "
                        "delta vs the uninterrupted run")
    p.add_argument("--min-devices", dest="minDevices", type=int, default=2,
                   help="kill-device mode: --minDevices for the elastic "
                        "job")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="kill-device mode: seconds each job may take")
    p.add_argument("--platform", default=None, choices=["cpu", "cuda"])
    p.add_argument("--workdir", default=None,
                   help="keep artifacts here instead of a fresh tempdir")
    # worker-only flags
    p.add_argument("--ckpt", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--faultPlan", default=None)
    p.add_argument("--faultLog", default=None)
    args = p.parse_args(argv)

    if args.worker:
        return worker_main(args)

    import numpy as np

    from bigdl_tpu_torch.resilience.supervisor import (RetryPolicy,
                                                       supervise_command)

    wd = args.workdir or tempfile.mkdtemp(prefix="chaos_")
    os.makedirs(wd, exist_ok=True)
    if args.killDevice:
        return _kill_device_mode(args, wd)
    if args.kill_steps:
        kills = sorted(int(t) for t in args.kill_steps.split(",") if t)
    else:
        n = max(args.kills, 0)
        kills = sorted({max(1, round(args.maxIt * (i + 1) / (n + 1)))
                        for i in range(n)})
    print(f"chaos: max_it={args.maxIt} ckpt_every={args.ckptEvery} "
          f"kills_at={kills} kill_in_ckpt={args.kill_in_ckpt} "
          f"workdir={wd}", flush=True)

    # 1. the uninterrupted reference run
    base_out = os.path.join(wd, "base.npz")
    rc = subprocess.call(_worker_argv(args, os.path.join(wd, "ck_base"),
                                      base_out))
    if rc != 0:
        print(f"chaos: baseline run failed rc={rc}", flush=True)
        return 2

    # 2. the chaos run: inject preemptions, restart and resume each time
    chaos_ck = os.path.join(wd, "ck_chaos")
    chaos_out = os.path.join(wd, "chaos.npz")
    fault_log = os.path.join(wd, "faults.jsonl")

    def _fired() -> tuple:
        """(step kills fired, ckpt kill fired), from the fault log: the
        dying child's own record."""
        steps, ckpt = 0, False
        if os.path.exists(fault_log):
            with open(fault_log) as f:
                for line in f:
                    if not line.strip():
                        continue
                    e = json.loads(line)
                    if e.get("fault") != "preempt":
                        continue
                    if e.get("site") == "step":
                        steps += 1
                    elif e.get("site") == "ckpt_save":
                        ckpt = True
        return steps, ckpt

    def make_argv(attempt: int) -> list:
        resumed = _resumed_iteration(chaos_ck)
        step_fired, ckpt_fired = _fired()
        entries = []
        remaining = kills[step_fired:]
        if remaining:
            # the injector counts per-process step visits; after a resume
            # at iteration r, global step k is local visit k - r
            local = remaining[0] - resumed
            if local >= 1:
                entries.append(f"preempt@step:{local}")
        if args.kill_in_ckpt and not ckpt_fired:
            # visit 2 = the state.<n> write of this attempt's first
            # snapshot: the pair is torn, resume must fall back
            entries.append("preempt@ckpt_save:2")
        plan = ";".join(entries)
        print(f"chaos: attempt {attempt + 1} resumed_at={resumed} "
              f"plan={plan or '(none)'}", flush=True)
        return _worker_argv(args, chaos_ck, chaos_out, plan, fault_log)

    expected_kills = len(kills) + (1 if args.kill_in_ckpt else 0)
    rc, events = supervise_command(
        make_argv, policy=RetryPolicy(budget=args.budget, base_s=0.05,
                                      max_s=0.5))
    if rc != 0:
        print(f"chaos: supervised run did not converge rc={rc} "
              f"events={json.dumps(events)}", flush=True)
        return 2

    # 3. every injected fault must be in the fault log (written by the
    #    dying child before os._exit)
    fault_events = []
    if os.path.exists(fault_log):
        with open(fault_log) as f:
            fault_events = [json.loads(line) for line in f if line.strip()]
    restarts = sum(1 for e in events if e.get("event") == "restart")

    # 4. the acceptance bit: parameters equal to the uninterrupted run's
    with np.load(base_out) as za, np.load(chaos_out) as zb:
        equal = (sorted(za.files) == sorted(zb.files)
                 and all(np.array_equal(za[k], zb[k]) for k in za.files))
    out = {"chaos": "kill_resume_equivalence", "max_it": args.maxIt,
           "ckpt_every": args.ckptEvery, "kills": kills,
           "kill_in_ckpt": args.kill_in_ckpt, "restarts": restarts,
           "equal": equal, "fault_events": fault_events,
           "supervisor_events": events}
    print(json.dumps(out), flush=True)
    ok = (equal and restarts == expected_kills
          and len(fault_events) == expected_kills
          and all(e.get("fault") == "preempt" for e in fault_events))
    if not ok:
        print(f"chaos: FAILED (equal={equal}, restarts={restarts}/"
              f"{expected_kills}, logged_faults={len(fault_events)}/"
              f"{expected_kills})", flush=True)
        return 1
    print(f"chaos: OK — {expected_kills} preemption(s), {restarts} "
          f"supervised restart(s), final params bit-identical", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
