"""Runtime utilities: logging, step timing, profiling, the live loss plot.

Counterpart of `synference_tpu/runtime.py`. `setup_logger` takes its rank
from `torch.distributed` where a process group is initialised (0
otherwise); `trace_profile` records a `torch.profiler` trace (the card's
kernels too, where there is one) and writes it to `log_dir` as a Chrome
trace; `span` and `traced` mark the program's own ranges in that trace;
`TerminalLossPlot` draws the same text as the JAX package's for the
same losses.
"""

from __future__ import annotations

import contextlib
import functools
import json
import logging
import os
import sys
import time

import numpy as np
import torch

__all__ = [
    "setup_logger",
    "StepTimer",
    "trace_profile",
    "span",
    "traced",
    "MetricsLogger",
    "TerminalLossPlot",
]


def _rank() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def setup_logger(name: str = "synference_tpu_torch",
                 level: int = logging.INFO) -> logging.Logger:
    """Rank-aware logger: rank 0 logs at `level`, other ranks at WARNING."""
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    rank = _rank()
    handler = logging.StreamHandler()
    handler.setFormatter(
        logging.Formatter(
            f"%(asctime)s [{name} p{rank}] %(levelname)s: %(message)s"
        )
    )
    logger.addHandler(handler)
    logger.setLevel(level if rank == 0 else logging.WARNING)
    return logger


class StepTimer:
    """Rolling step-time statistics (steps/sec, ETA), host clock."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times = []
        self._last = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    @property
    def steps_per_sec(self) -> float:
        if not self._times:
            return 0.0
        return len(self._times) / sum(self._times)

    def eta_seconds(self, remaining_steps: int) -> float:
        sps = self.steps_per_sec
        return remaining_steps / sps if sps > 0 else float("inf")


@contextlib.contextmanager
def trace_profile(log_dir: str):
    """`torch.profiler` over the block (CPU, and CUDA where a card is
    present); on exit the trace goes to `log_dir/trace.json` (open it in
    Perfetto or chrome://tracing). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# The profiler's own flag: one call, and no range made, while no profiler
# records (entering a `record_function` costs microseconds even then).
_profiling = torch._C._autograd._profiler_enabled
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A range `synference::<name>` in the trace of a recording
    `torch.profiler` (`trace_profile`'s), on the clock of the card's
    kernels; a shared no-op context while none records. Ranges nest on the
    host thread, so a range's parent is the one open around it. A span
    never synchronises the device and never allocates on it."""
    if not _profiling():
        return _NO_SPAN
    # the profiler's fast record function: a `cpu_op` range of the trace.
    # `torch.profiler.record_function` would add a GPU-side annotation over
    # the kernels launched inside it, which a reader of the trace's device
    # timeline would count as device work.
    return torch._C._profiler._RecordFunctionFast("synference::" + name)


def traced(name: str):
    """Decorator: each call of the function is `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


class MetricsLogger:
    """Append-only JSONL metrics sink."""

    def __init__(self, path: str):
        self.path = path

    def log(self, **metrics):
        metrics.setdefault("t", time.time())
        with open(self.path, "a") as f:
            f.write(json.dumps(metrics) + "\n")

    def read(self) -> list:
        out = []
        with open(self.path) as f:
            for line in f:
                if line.strip():
                    out.append(json.loads(line))
        return out


def _mean(loss) -> float:
    """The mean of a scalar, array or tensor of losses, as a float."""
    if isinstance(loss, torch.Tensor):
        loss = loss.detach().cpu().numpy()
    return float(np.mean(loss))


class TerminalLossPlot:
    """Live in-terminal train/val loss chart, redrawn in place each epoch.

    On ANSI terminals the frame overdraws itself with cursor-up escapes;
    on other streams (logs, CI) it prints one line per epoch. The text is
    the JAX package's, character for character, for the same losses.
    """

    def __init__(self, width: int = 64, height: int = 10, stream=None,
                 ansi: bool | None = None, label: str = "loss"):
        self.width = int(width)
        self.height = int(height)
        self.stream = stream if stream is not None else sys.stdout
        self.ansi = (self.stream.isatty() if ansi is None
                     and hasattr(self.stream, "isatty") else bool(ansi))
        self.label = label
        self._train: list = []
        self._val: list = []
        self._lines_drawn = 0

    def update(self, epoch: int, train_loss, val_loss=None):
        """Record one epoch and redraw. Losses may be scalars, per-member
        arrays or tensors (ensembles plot the member mean)."""
        self._train.append(_mean(train_loss))
        if val_loss is not None:
            self._val.append(_mean(val_loss))
        if self.ansi:
            self._draw(epoch)
        else:
            v = (f"  val {self._val[-1]:.4f}" if self._val else "")
            print(f"epoch {epoch:4d}  train {self._train[-1]:.4f}{v}",
                  file=self.stream, flush=True)

    # -- rendering ---------------------------------------------------------
    def _series_to_cols(self, series, lo, span):
        n = len(series)
        xs = np.linspace(0, n - 1, self.width) if n > 1 else np.zeros(1)
        ys = np.interp(xs, np.arange(n), np.asarray(series))
        rows = ((ys - lo) / span * (self.height - 1)).round().astype(int)
        return np.clip(rows, 0, self.height - 1)

    def _draw(self, epoch: int):
        both = self._train + self._val
        lo, hi = float(np.min(both)), float(np.max(both))
        span = max(hi - lo, 1e-12)
        grid = [[" "] * self.width for _ in range(self.height)]
        for series, ch in ((self._train, "·"), (self._val, "●")):
            if not series:
                continue
            cols = self._series_to_cols(series, lo, span)
            for cx, row in enumerate(cols[: self.width]):
                grid[self.height - 1 - int(row)][cx] = ch
        v = (f"  val {self._val[-1]:.4f}" if self._val else "")
        head = (f"{self.label}  epoch {epoch}  "
                f"train {self._train[-1]:.4f}{v}")
        lines = [head]
        lines.append(f"{hi:10.3f} ┤" + "".join(grid[0]))
        for r in grid[1:-1]:
            lines.append(" " * 10 + " │" + "".join(r))
        lines.append(f"{lo:10.3f} ┤" + "".join(grid[-1]))
        lines.append(" " * 12 + "· train   ● val")
        if self._lines_drawn:
            self.stream.write(f"\x1b[{self._lines_drawn}A")
        for ln in lines:
            self.stream.write("\x1b[2K" + ln + "\n")
        self.stream.flush()
        self._lines_drawn = len(lines)
