"""On-demand profile capture windows mid-run (counterpart of
``bigdl_tpu/obs/capture.py``).

A bounded ``torch.profiler`` window opens between two dispatches,
triggered three ways:

* ``--traceSteps N@M``: capture steps M..M+N-1 (planned ahead: skip the
  warm-up, profile the steady state);
* ``SIGUSR2``: ``kill -USR2 <pid>`` opens a window of ``window_steps`` at
  the next step boundary (the handler installs on the main thread only);
* touch-file: ``touch <traceDir>/CAPTURE`` does the same from a shell
  that only shares a filesystem with the run; the file is consumed when
  the window opens, so one touch is one capture.

A window is ``torch.profiler.profile(activities=[CPU] + [CUDA] on the
card)`` started and stopped around the steps, exported to
``<trace_dir>/capture_<step>/trace.json``, and VERIFIED on close: the
trace must parse with ``utils/kineto.parse_trace``. A verified window is
attributed (``obs/attrib``: per-category device time and the MFU
decomposition when the harness installed its numerators) and published
as ``attrib_*`` gauges. ``torch.profiler`` allows one session a process:
a window that opens while another profiler runs (``cli.perf --profile``)
records its error, as the JAX window does for a second ``start_trace``.

The controller is driven by one ``on_step(step)`` call a dispatch, before
the step runs; callers hold None when no capture is configured. A window
opens and closes only between dispatches, never while a CUDA graph is
being captured (the first ``on_step`` comes after the warm-up that
captures)."""

from __future__ import annotations

import logging
import os
import re
import signal as _signal
import threading
from typing import List, Optional, Tuple

logger = logging.getLogger("bigdl_tpu_torch")

__all__ = ["CaptureController", "parse_trace_steps", "TOUCH_FILE_NAME"]

TOUCH_FILE_NAME = "CAPTURE"

# the costliest kernel names a window records per category
TOP_NAMES = 8

_SPEC_RE = re.compile(r"^(\d+)@(\d+)$")


def parse_trace_steps(spec: str) -> Tuple[int, int]:
    """``"N@M"`` -> ``(n_steps, start_step)``; steps are 0-indexed
    dispatch counts (M=0 captures from the first timed step)."""
    m = _SPEC_RE.match(str(spec).strip())
    if not m:
        raise ValueError(
            f"--traceSteps {spec!r}: expected N@M (capture N steps "
            f"starting at step M), e.g. 5@20")
    n, start = int(m.group(1)), int(m.group(2))
    if n < 1:
        raise ValueError(f"--traceSteps {spec!r}: N must be >= 1")
    return n, start


def _is_cuda(device) -> bool:
    return device is not None and getattr(device, "type", device) == "cuda"


def _profiler_activities(device) -> list:
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if _is_cuda(device):
        acts.append(ProfilerActivity.CUDA)
    return acts


class CaptureController:
    """Bounded mid-run ``torch.profiler`` windows with post-close
    verification.

    ``captures`` (and :meth:`annotation`) records one dict a window:
    ``{start_step, stop_step, trigger, dir, trace, planes, ok}`` plus
    ``error`` when the profiler or the verify failed, and ``attrib`` (or
    ``attrib_error``) after the attribution. ``device`` is where the
    steps run: on a CUDA device the window records the card's kernels
    too."""

    def __init__(self, trace_dir: str, trace_steps: Optional[str] = None,
                 window_steps: int = 5, touch_file: Optional[str] = None,
                 install_signal: bool = True, device=None):
        self.trace_dir = str(trace_dir)
        self.device = device
        # attribution context: the harness that knows its step FLOPs and
        # peak installs them, so each verified window closes with an
        # MFU-decomposed attribution; None = times only
        self.step_flops: Optional[float] = None
        self.flops_by_kind: Optional[dict] = None
        self.peak_flops: Optional[float] = None
        # the gradient wire's configuration, stamped into each attributed
        # window so a collective_s reads against the bytes it moved
        self.grad_comm: Optional[dict] = None
        os.makedirs(self.trace_dir, exist_ok=True)
        self._planned: Optional[Tuple[int, int]] = (
            parse_trace_steps(trace_steps) if trace_steps else None)
        self.window_steps = max(1, int(window_steps))
        self.touch_file = (touch_file if touch_file is not None
                           else os.path.join(self.trace_dir,
                                             TOUCH_FILE_NAME))
        self.captures: List[dict] = []
        self._active: Optional[dict] = None
        self._prof = None
        self._stop_at: int = 0
        self._signal_pending = False
        self._prev_handler = None
        if install_signal:
            self._install_signal()

    # ------------------------------------------------------------ triggers
    def _install_signal(self) -> None:
        def _handler(signum, frame):
            # a flag only: the next on_step boundary acts on it, never a
            # profiler started in the middle of a dispatch
            self._signal_pending = True

        if threading.current_thread() is threading.main_thread():
            self._prev_handler = _signal.signal(_signal.SIGUSR2, _handler)

    def request_capture(self) -> None:
        """Programmatic trigger (SIGUSR2's path): open a ``window_steps``
        window at the next step boundary."""
        self._signal_pending = True

    def _touch_triggered(self) -> bool:
        if not self.touch_file or not os.path.exists(self.touch_file):
            return False
        try:  # consume: one touch = one capture
            os.remove(self.touch_file)
        except OSError:
            pass
        return True

    # ---------------------------------------------------------------- steps
    def on_step(self, step: int) -> None:
        """One call a dispatch, BEFORE the step runs. Opens a pending
        window at its start step and closes and verifies an open window
        at its stop step."""
        if self._active is not None:
            if step >= self._stop_at:
                self._stop()
            else:
                return  # window still open; triggers wait for it
        if self._planned is not None and step >= self._planned[1]:
            n, start = self._planned
            self._planned = None
            self._start(step, step + n, trigger=f"traceSteps:{n}@{start}")
            return
        if self._signal_pending:
            self._signal_pending = False
            self._start(step, step + self.window_steps, trigger="signal")
            return
        if self._touch_triggered():
            self._start(step, step + self.window_steps, trigger="touch")

    def finish(self) -> None:
        """End-of-run drain: close a still-open window (a --traceSteps
        spec past the last step, or a trigger near the end) and put the
        previous SIGUSR2 handler back."""
        if self._active is not None:
            self._stop()
        if self._prev_handler is not None:
            _signal.signal(_signal.SIGUSR2, self._prev_handler)
            self._prev_handler = None

    # --------------------------------------------------------------- window
    def _start(self, step: int, stop_at: int, trigger: str) -> None:
        d = os.path.join(self.trace_dir, f"capture_{step}")
        rec = {"start_step": step, "stop_step": stop_at,
               "trigger": trigger, "dir": d, "ok": False}
        try:
            import torch
            from torch.profiler import profile
            if torch.autograd._profiler_enabled():
                # a second session would silently end the first one
                raise RuntimeError("another torch.profiler session is "
                                   "running in this process")
            self._sync()
            prof = profile(activities=_profiler_activities(self.device))
            prof.start()
        except Exception as e:  # a second profiler session, no CUPTI...
            rec["error"] = f"start: {type(e).__name__}: {e}"[:200]
            self.captures.append(rec)
            logger.warning("obs capture failed to open at step %d: %s",
                           step, rec["error"])
            return
        self._prof = prof
        self._active = rec
        self._stop_at = stop_at
        logger.info("obs capture open at step %d (until %d, trigger=%s) "
                    "-> %s", step, stop_at, trigger, d)

    def _sync(self) -> None:
        """Wait for the card, so a window holds the steps it names."""
        if _is_cuda(self.device):
            import torch
            torch.cuda.synchronize(self.device)

    def _stop(self) -> None:
        rec, self._active = self._active, None
        prof, self._prof = self._prof, None
        path = os.path.join(rec["dir"], "trace.json")
        try:
            self._sync()
            prof.stop()
            os.makedirs(rec["dir"], exist_ok=True)
            prof.export_chrome_trace(path)
        except Exception as e:
            rec["error"] = f"stop: {type(e).__name__}: {e}"[:200]
            self.captures.append(rec)
            logger.warning("obs capture failed to close: %s", rec["error"])
            return
        self._verify(rec)
        self.captures.append(rec)
        logger.info("obs capture closed: %s (ok=%s, %s planes)",
                    rec["dir"], rec["ok"], rec.get("planes"))

    def _verify(self, rec: dict) -> None:
        """A capture only counts if the reader parses it: the point of a
        window is a trace someone can read."""
        from bigdl_tpu_torch.utils.kineto import find_trace, parse_trace
        path = find_trace(rec["dir"])
        if path is None:
            rec["error"] = "no trace.json written"
            return
        rec["trace"] = path
        try:
            planes = parse_trace(path)
        except Exception as e:
            rec["error"] = f"trace parse: {type(e).__name__}: {e}"[:200]
            return
        rec["planes"] = len(planes)
        rec["ok"] = bool(planes)
        if not planes:
            rec["error"] = "trace parsed but holds no kernel or operator"
            return
        if _is_cuda(self.device) and not any(
                ln.events for p in planes if p.name.startswith("/device")
                for ln in p.lines):
            # the host fallback is for CPU windows: on the card, operator
            # time read as device time would be a wrong answer
            rec["ok"] = False
            rec["error"] = "no device events (CUPTI recorded no kernel)"
            return
        self._attribute(rec, planes)

    def _attribute(self, rec: dict, planes) -> None:
        """Post-capture attribution: per-category device time with the
        collective breakout, stamped into the record and published as
        ``attrib_*`` gauges. A failure is recorded, never raised: a
        window that parsed but resisted classification is still a good
        capture."""
        try:
            from bigdl_tpu_torch.obs import attrib as _attrib
            from bigdl_tpu_torch.obs.metrics import get_registry
            steps = max(1, int(rec["stop_step"]) - int(rec["start_step"]))
            summary = _attrib.attribute(
                planes, steps=steps, step_flops=self.step_flops,
                flops_by_kind=self.flops_by_kind,
                peak_flops=self.peak_flops, top_ops=TOP_NAMES)
            rec["attrib"] = _attrib.compact(summary)
            # the costliest names of each category (and of host_other,
            # the remainder a reader must see)
            rec["top"] = {c: d["top"] for c, d in
                          summary["categories"].items() if d["top"]}
            if self.grad_comm is not None:
                rec["grad_comm"] = dict(self.grad_comm)
            _attrib.publish(summary, get_registry())
        except Exception as e:
            rec["attrib_error"] = (
                f"attrib: {type(e).__name__}: {e}"[:200])
            logger.warning("obs capture attribution failed: %s",
                           rec["attrib_error"])

    # ----------------------------------------------------------- reporting
    def annotation(self) -> List[dict]:
        """Capture records for the result line (absolute paths)."""
        return [dict(r) for r in self.captures]
