"""NPE training: `SBIFitter.run_single_sbi` of the configuration's NSF
ensemble, whose `train_ensemble` epoch loop is the window.

Set-up builds the training data with the program as a user does: a
library of `library_rows` (`generate`, on the benchmark's grid and
filters), every k-th row of it (`train_library_rows`), and the
configuration's features (asinh, depth noise, errors). That data is the
cell's input: the program's trainer and the reference get the same
arrays. Training runs with patience above any window; the window opens
at the end of epoch 0 (the first epoch, which warms up every shape, is
set-up) and closes at the first epoch boundary at or after `seconds`,
where the epoch callback stops the loop. `train_step_ms` is the window's
wall time over the optimiser steps finished in it; those epochs include
their shuffles, minibatch gathers and validation passes.

The check replays, in float64 with the plain model (`reference/nsf.py`),
the first three steps from the program's initial parameters on the
minibatches the program gathered, and compares each step's loss, the
first clipped gradient as the optimiser's first moment holds it after one
step, and the parameters' change after three steps, leaf by leaf; the
first validation pass's loss from the parameters it saw; and that every
minibatch row is a row of the data, no row twice in a member's batch. It
reads the program's state through its step, `_EnsembleState.train_step`
(the state's `params`, `m` and `flat`), and `train._validation_loss`.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.drivers import generate
from benchmark.reference import nsf as ref_nsf
from benchmark.reference.forward import tf32_round

_B1 = 0.9


def _clone(tree):
    return ref_nsf.tree_map(lambda a: a.detach().clone(), tree)


class _Capture:
    """Wraps the program's step and validation pass: counts steps, and
    keeps what the check needs from the first three steps and the first
    validation pass. Reads nothing back to the host."""

    def __init__(self, train_mod):
        self.mod = train_mod
        self.steps = 0
        self.p0 = self.g1 = self.p3 = None
        self.batches, self.losses = [], []
        self.val = None
        self.val_calls = 0
        self._step = train_mod._EnsembleState.train_step
        self._val = train_mod._validation_loss
        cap = self

        def train_step(state, loss_fn, theta_b, x_b):
            if cap.steps == 0:
                cap.p0 = _clone(state.params)
            loss = cap._step(state, loss_fn, theta_b, x_b)
            cap.steps += 1
            if cap.steps <= 3:
                cap.batches.append((theta_b, x_b))
                cap.losses.append(loss.clone())
            if cap.steps == 1:
                cap.g1 = _clone(state.unpack(state.m / (1.0 - _B1)))
            if cap.steps == 3:
                cap.p3 = _clone(state.params)
            return loss

        def validation_loss(loss_fn, params, t_va, x_va):
            out = cap._val(loss_fn, params, t_va, x_va)
            if cap.val is None:
                cap.val = (_clone(params), t_va, x_va, out.clone())
            cap.val_calls += 1
            return out

        train_mod._EnsembleState.train_step = train_step
        train_mod._validation_loss = validation_loss

    def restore(self):
        self.mod._EnsembleState.train_step = self._step
        self.mod._validation_loss = self._val


def _features_config(tt, cfg, codes):
    f = cfg["features"]
    return tt.FeatureConfig(filter_codes=tuple(codes), unit=f["unit"],
                            depths_ab=(f["depth_ab"],) * len(codes),
                            n_scatters=f["n_scatters"],
                            include_errors=f["include_errors"])


def run(ctx) -> dict:
    import synference_tpu_torch as tt
    from synference_tpu_torch import train as train_mod

    cfg, dev = ctx.config, ctx.device
    gen, _, _ = generate.build(ctx)
    n_lib = int(cfg["library_rows"])
    lib = gen.generate(n=n_lib, seed=ctx.seed_of(0, salt=2))
    every = n_lib // int(cfg["train_library_rows"])
    del gen
    fitter = tt.SBIFitter(
        photometry=lib["photometry"].T[::every],
        parameters=lib["parameters"].T[::every],
        parameter_names=lib["parameter_names"],
        filter_codes=lib["filter_codes"], device=dev)
    fitter.create_feature_array(
        _features_config(tt, cfg, fitter.filter_codes),
        generator=torch.Generator(device=dev).manual_seed(
            ctx.seed_of(0, salt=3)))
    fl = cfg["flow"]
    tcfg = tt.TrainConfig(batch_size=fl["batch_size"],
                          learning_rate=fl["learning_rate"],
                          validation_fraction=fl["validation_fraction"],
                          max_epochs=100_000, stop_after_epochs=100_000)
    cap = _Capture(train_mod)
    marks = {}

    def on_epoch(epoch, train_loss, val_loss):
        if epoch == 0:
            ctx.begin_window()
            marks["steps0"], marks["val0"] = cap.steps, cap.val_calls
            return False
        if time.perf_counter() < ctx.t_begin + ctx.seconds:
            return False
        ctx.end_window()
        marks["steps1"], marks["val1"] = cap.steps, cap.val_calls
        return True

    try:
        fitter.run_single_sbi(
            fl["model_type"], hidden_features=fl["hidden_features"],
            num_transforms=fl["num_transforms"], n_nets=fl["n_nets"],
            train_config=tcfg,
            generator=torch.Generator(device=dev).manual_seed(
                ctx.seed_of(0, salt=4)),
            epoch_callback=on_epoch)
    finally:
        cap.restore()
    steps = marks["steps1"] - marks["steps0"]
    vals = marks["val1"] - marks["val0"]
    ctx.counters["steps"] = steps
    if ctx.trace:
        ctx.work = _work(cfg, fitter, steps, vals, cap)
    state = {"cap": cap, "theta": fitter.feature_params,
             "x": fitter.features}
    del fitter
    return {"metrics": {"train_step_ms": 1e3 * ctx.window_s / steps},
            "attempted": steps, "failed": 0, "state": state}


def _work(cfg, fitter, steps: int, vals: int, cap) -> dict:
    """Matrix-product operations of the window: per step the ensemble's
    conditioner MLPs forward and backward (3× forward) on the batch, per
    validation pass their forward on the validation rows."""
    fl = cfg["flow"]
    d, c = fitter.feature_params.shape[1], fitter.features.shape[1]
    half_a, half_b = d // 2, d - d // 2
    h = fl["hidden_features"]
    sizes = [half_a + c, h, h, half_b * (3 * 8 + 1)]
    per_row = 2.0 * sum(a * b for a, b in zip(sizes[:-1], sizes[1:])) * \
        fl["num_transforms"] * fl["n_nets"]
    n_val = cap.val[1].shape[0] if cap.val is not None else 0
    ops = steps * 3.0 * per_row * fl["batch_size"] + vals * per_row * n_val
    return {"ops": ops, "steps": steps}


def _row_keys(theta, x):
    """An exact integer key per row of (θ, x): the float32 bits times fixed
    odd multipliers, summed modulo 2^64."""
    bits = torch.cat([theta.float(), x.float()], dim=-1).contiguous().view(
        torch.int32).to(torch.int64)
    gen = torch.Generator(device="cpu").manual_seed(12345)
    mult = (torch.randint(1, 2 ** 62, (bits.shape[-1],), generator=gen,
                          dtype=torch.int64) | 1).to(bits.device)
    return (bits * mult).sum(-1)


def _replay(flow, p0, batches, lr: float, dtype):
    """The first steps in `dtype` from the parameters `p0`: each step's
    (K,) loss, the first clipped gradient, the parameters after the last
    step (leaves), and each step's clipped gradient norms per leaf."""
    params = ref_nsf.tree_map(lambda a: a.to(dtype), p0)
    k = ref_nsf.leaves(params)[0].shape[0]
    opt = ref_nsf.AdamW(params, torch.full((k,), lr, dtype=dtype,
                                           device=params["x_mean"].device),
                        clip=5.0, weight_decay=0.0)
    p_leaves = ref_nsf.leaves(params)
    losses, norms, g1 = [], [], None
    for tb, xb in batches:
        leaves = [p.detach().requires_grad_() for p in p_leaves]
        loss = ref_nsf.npe_loss(flow, ref_nsf.unflatten(params, leaves),
                                tb, xb)
        grads = torch.autograd.grad(loss.sum(), leaves)
        clipped = opt.clipped([g.detach() for g in grads])
        losses.append(loss.detach())
        norms.append([float(g.double().norm()) for g in clipped])
        g1 = clipped if g1 is None else g1
        p_leaves = opt.step([p.detach() for p in leaves], clipped)
    return losses, g1, p_leaves, norms


def _val_loss(flow, params, t_va, x_va, dtype):
    params = ref_nsf.tree_map(lambda a: a.to(dtype), params)
    k = params["x_mean"].shape[0]
    total = torch.zeros(k, dtype=torch.float64, device=t_va.device)
    n = t_va.shape[0]
    with torch.no_grad():
        for i in range(0, n, 16384):
            tb, xb = t_va[i:i + 16384], x_va[i:i + 16384]
            lp = flow.log_prob(params, tb.expand(k, *tb.shape),
                               xb.expand(k, *xb.shape))
            total -= lp.sum(-1).double() / n
    return total


def _gap(prog, ref):
    """Largest |prog − ref| / max(|ref|, 1) over members."""
    return float(((prog.double() - ref.double()).abs()
                  / ref.double().abs().clamp(min=1.0)).max())


def _worst_leaf(prog, ref, keep) -> float:
    """The worst leaf's gap of norms, |‖prog‖ − ‖ref‖|, against the larger
    of the reference leaf's norm and the median leaf's (the median of the
    leaves the reference moves at all: at the first step a zero last layer
    leaves every hidden layer's gradient exactly zero)."""
    ref_n = np.array([float(r.double().norm()) for r in ref])
    prog_n = np.array([float(p.double().norm()) for p in prog])
    floor = np.median(ref_n[ref_n > 0]) if (ref_n > 0).any() else 1.0
    gap = np.abs(prog_n - ref_n) / np.maximum(ref_n, floor)
    gap = gap[keep]
    return float(gap.max()) if gap.size else 0.0


def _flow(ctx, state, round_fn=None):
    fl = ctx.config["flow"]
    theta = torch.as_tensor(state["theta"])
    return ref_nsf.NSF(theta.shape[1], state["x"].shape[1],
                       fl["num_transforms"], 8, 3.5,
                       (theta.min(0).values.numpy(),
                        theta.max(0).values.numpy()), ctx.device,
                       round_fn=round_fn)


def _readings(ctx, state, prog: dict) -> dict:
    """The compared numbers of `prog` ({"losses", "g1", "p3", "val"})
    against the float64 replay of the reference."""
    cap = state["cap"]
    f64 = torch.float64
    lr = ctx.config["flow"]["learning_rate"]
    if "ref" not in state:
        flow = _flow(ctx, state)
        state["ref"] = (_replay(flow, cap.p0, cap.batches, lr, f64),
                        _val_loss(flow, cap.val[0], cap.val[1], cap.val[2],
                                  f64))
    (losses, g1, p3, norms), val = state["ref"]
    p0 = ref_nsf.leaves(cap.p0)
    g_max = np.max(np.array(norms), axis=0)
    moving = g_max >= 1e-3 * np.median(g_max)
    return {
        "step_loss_gap": max(_gap(a, b)
                             for a, b in zip(prog["losses"], losses)),
        "grad1_leaf_gap": _worst_leaf(prog["g1"], g1,
                                      np.ones(len(g1), bool)),
        "change3_leaf_gap": _worst_leaf(
            [a.double() - b.double() for a, b in zip(prog["p3"], p0)],
            [a - b.double() for a, b in zip(p3, p0)], moving),
        "val_loss_gap": _gap(prog["val"], val),
    }


def check(ctx, state) -> list:
    cap = state["cap"]
    dev = ctx.device
    theta_all = torch.as_tensor(state["theta"], device=dev)
    x_all = torch.as_tensor(state["x"], device=dev)
    # every minibatch row is a row of the data, none twice in a batch
    keys = torch.sort(_row_keys(theta_all, x_all)).values
    missing = repeats = 0
    for tb, xb in cap.batches:
        k = _row_keys(tb, xb)  # (K, B)
        pos = torch.searchsorted(keys, k).clamp(max=keys.numel() - 1)
        missing += int((keys[pos] != k).sum())
        srt = torch.sort(k, dim=1).values
        repeats += int((srt[:, 1:] == srt[:, :-1]).sum())
    got = {"batch_rows_not_in_data": missing,
           "batch_rows_repeated": repeats}
    got.update(_readings(ctx, state, {
        "losses": cap.losses, "g1": ref_nsf.leaves(cap.g1),
        "p3": ref_nsf.leaves(cap.p3), "val": cap.val[3]}))
    return [(k, v, ctx.limits[k]) for k, v in got.items()]


def control(ctx, state) -> dict:
    """The control: the reference in float32 with its matrix products'
    operands rounded to TF32 (the precision below the configuration's),
    put in the program's place."""
    cap = state["cap"]
    flow = _flow(ctx, state, round_fn=tf32_round)
    lr = ctx.config["flow"]["learning_rate"]
    losses, g1, p3, _ = _replay(flow, cap.p0, cap.batches, lr,
                                torch.float32)
    val = _val_loss(flow, cap.val[0], cap.val[1], cap.val[2], torch.float32)
    return _readings(ctx, state, {"losses": losses, "g1": g1, "p3": p3,
                                  "val": val})


def faults(ctx, state) -> dict:
    """Readings of a planted fault, the reference put in the program's
    place: each step's mean taken over half of the batch (float32, TF32
    off). A state left unchanged reads 1 on the change by construction."""
    cap = state["cap"]
    flow = _flow(ctx, state)
    lr = ctx.config["flow"]["learning_rate"]
    half = [(tb[:, :tb.shape[1] // 2], xb[:, :xb.shape[1] // 2])
            for tb, xb in cap.batches]
    losses, g1, p3, _ = _replay(flow, cap.p0, half, lr, torch.float32)
    val = _val_loss(flow, cap.val[0], cap.val[1], cap.val[2], torch.float32)
    return {"half_batch": _readings(ctx, state, {
        "losses": losses, "g1": g1, "p3": p3, "val": val})}
