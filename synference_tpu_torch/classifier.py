"""A small MLP classifier trained for many members at once.

The JAX package's `c2st` and `restricted_prior_from_simulations` call
sklearn's `MLPClassifier` (one hidden layer of 64 ReLU units, a logistic
output, log-loss with an L2 penalty, Adam). The card machine has no sklearn,
so the port trains its own with sklearn's defaults: Adam at learning rate
1e-3 (β 0.9, 0.999, ε 1e-8, in sklearn's form), α = 1e-4, minibatches of
min(200, n) rows reshuffled every epoch, at most 300 epochs, and a stop
once the epoch's training loss has not improved on the best by 1e-4 for
more than 10 epochs. Weights start Glorot-uniform, as sklearn's do.

K members, each with its own training rows (a C2ST fold, an object), train
as one member axis: every step is one batched forward and backward pass for
all of them, with the gradients written out by hand. A member whose rows
run out before the others' skips the remaining batches of an epoch, and a
member that has stopped is frozen, so each follows its own sklearn
schedule. The initial weights and shuffles come from a `torch.Generator`,
so the result is held to sklearn's by value, not bit for bit.
"""

from __future__ import annotations

import math

import torch

__all__ = ["MLPClassifier", "train_members", "member_logits"]

_B1, _B2, _EPS = 0.9, 0.999, 1.0e-8


def _sizes(d_in: int, hidden: int):
    return [d_in * hidden, hidden, hidden, 1]


def _unpack(flat, d_in: int, hidden: int):
    """(K, n_params) -> w1 (K, d_in, H), b1 (K, H), w2 (K, H), b2 (K,),
    views of the buffer."""
    k = flat.shape[0]
    w1, b1, w2, b2 = flat.split(_sizes(d_in, hidden), dim=1)
    return w1.view(k, d_in, hidden), b1, w2, b2[:, 0]


def _init(generator, k: int, d_in: int, hidden: int, device):
    """Glorot-uniform weights and biases, bound sqrt(6 / (fan_in +
    fan_out)) per layer, as sklearn draws them for a ReLU network."""
    b_in = math.sqrt(6.0 / (d_in + hidden))
    b_out = math.sqrt(6.0 / (hidden + 1))
    bounds = torch.cat([torch.full((d_in * hidden + hidden,), b_in),
                        torch.full((hidden + 1,), b_out)]).to(device)
    u = torch.rand((k, bounds.shape[0]), generator=generator, device=device)
    return (2.0 * u - 1.0) * bounds


def member_logits(flat, x, d_in: int, hidden: int):
    """(K, n_params) weights, x (K, N, d_in) -> logits (K, N)."""
    w1, b1, w2, b2 = _unpack(flat, d_in, hidden)
    h = torch.relu(torch.baddbmm(b1[:, None, :], x, w1))
    return (h @ w2[:, :, None])[..., 0] + b2[:, None]


def train_members(x, y, n_rows, generator: torch.Generator,
                  hidden: int = 64, learning_rate: float = 1.0e-3,
                  alpha: float = 1.0e-4, batch_size: int = 200,
                  max_iter: int = 300, tol: float = 1.0e-4,
                  n_iter_no_change: int = 10):
    """Train K classifiers, member k on rows [0, n_rows[k]) of x[k], y[k].

    Args:
        x: (K, N, d) features; rows past a member's count are padding.
        y: (K, N) labels in {0, 1}.
        n_rows: (K,) host sequence of each member's row count.
    Returns:
        (K, n_params) weights for `member_logits`, and the (K,) number of
        epochs each member ran.

    A minibatch step is ~75 small kernels; on a CUDA device it is one
    captured CUDA graph, replayed with the batch's start in a device
    buffer (launched one by one the host sets its pace, ~1.2 ms a step on
    an H100). The epoch's permutation, loss and stopping test run outside
    it, one read of the members' activity per epoch.
    """
    dev = x.device
    k, n_max, d_in = x.shape
    n_rows_t = torch.as_tensor(list(n_rows), dtype=torch.float32,
                               device=dev)
    bs = min(batch_size, n_max)
    n_batches = -(-n_max // bs)
    # the training state, updated in place so that a graph can replay it
    st = {"flat": _init(generator, k, d_in, hidden, dev)}
    st["m"], st["v"] = torch.zeros_like(st["flat"]), torch.zeros_like(
        st["flat"])
    st["steps"] = torch.zeros((k,), device=dev)
    st["loss"] = torch.zeros((k,), device=dev)
    st["active"] = torch.ones((k,), dtype=torch.bool, device=dev)
    st["order"] = torch.zeros((k, n_batches * bs), dtype=torch.int64,
                              device=dev)
    st["start"] = torch.zeros((), device=dev)
    pad = torch.arange(n_max, device=dev)[None, :] >= n_rows_t[:, None]
    cols = torch.arange(bs, device=dev)
    yf = y.to(torch.float32)

    def step():
        """One minibatch of every member from `st["start"]`, in place."""
        idx = torch.gather(st["order"], 1, (st["start"].long() + cols)[
            None].expand(k, -1))
        count = torch.clamp(n_rows_t - st["start"], 0.0, float(bs))
        live = (count > 0) & st["active"]
        valid = (cols[None, :] < count[:, None]).to(torch.float32)
        xb = torch.gather(x, 1, idx[..., None].expand(-1, -1, d_in))
        yb = torch.gather(yf, 1, idx)
        loss, grad = _loss_and_grad(st["flat"], xb, yb, valid, count, alpha,
                                    d_in, hidden)
        st["loss"].add_(loss * count)
        st["steps"].add_(live.to(torch.float32))
        t = torch.clamp(st["steps"], min=1.0)[:, None]
        on = live[:, None]
        m, v = st["m"], st["v"]
        m.copy_(torch.where(on, _B1 * m + (1.0 - _B1) * grad, m))
        v.copy_(torch.where(on, _B2 * v + (1.0 - _B2) * grad * grad, v))
        lr = learning_rate * torch.sqrt(1.0 - _B2 ** t) / (1.0 - _B1 ** t)
        st["flat"].copy_(torch.where(
            on, st["flat"] - lr * m / (torch.sqrt(v) + _EPS), st["flat"]))

    run = _graphed(step, st, dev) if dev.type == "cuda" else step
    best = torch.full((k,), torch.inf, device=dev)
    stale = torch.zeros((k,), device=dev)
    epochs = torch.zeros((k,), device=dev)
    for _ in range(max_iter):
        # a fresh permutation of each member's own rows, padding last
        keys = torch.rand((k, n_max), generator=generator, device=dev)
        st["order"][:, :n_max] = torch.argsort(
            keys + pad.to(torch.float32) * 2.0, dim=1)
        st["loss"].zero_()
        for b in range(n_batches):
            st["start"].fill_(float(b * bs))
            run()
        epoch_loss = st["loss"] / n_rows_t
        active = st["active"]
        epochs = epochs + active.to(torch.float32)
        stale = torch.where(epoch_loss > best - tol, stale + 1.0, 0.0)
        best = torch.where(active, torch.minimum(best, epoch_loss), best)
        active.copy_(active & (stale <= n_iter_no_change))
        if not bool(active.any()):
            break
    return st["flat"], epochs


def _graphed(step, state: dict, device):
    """`step` captured as one CUDA graph over the tensors of `state`: two
    warm-up steps on a side stream (their changes undone afterwards), then
    the capture, which runs nothing. Returns the replay."""
    saved = {key: t.clone() for key, t in state.items()}
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(2):
            step()
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin()
        step()
        graph.capture_end()
        for key, t in state.items():
            t.copy_(saved[key])
    torch.cuda.current_stream(device).wait_stream(side)
    return graph.replay


def _loss_and_grad(flat, xb, yb, valid, count, alpha: float, d_in: int,
                   hidden: int):
    """Per-member minibatch log-loss + α/(2n)·Σw² over its `count` valid
    rows, and its gradient in the layout of `flat`, by hand."""
    w1, b1, w2, b2 = _unpack(flat, d_in, hidden)
    n = torch.clamp(count, min=1.0)
    pre = torch.baddbmm(b1[:, None, :], xb, w1)
    h = torch.relu(pre)
    z = (h @ w2[:, :, None])[..., 0] + b2[:, None]
    bce = torch.nn.functional.softplus(z) - yb * z
    l2 = (w1 * w1).sum(dim=(1, 2)) + (w2 * w2).sum(dim=1)
    loss = (bce * valid).sum(dim=1) / n + 0.5 * alpha * l2 / n
    delta = (torch.sigmoid(z) - yb) * valid / n[:, None]  # (K, B)
    g_w2 = (h * delta[..., None]).sum(dim=1) + alpha * w2 / n[:, None]
    g_b2 = delta.sum(dim=1, keepdim=True)
    d_h = delta[..., None] * w2[:, None, :] * (pre > 0)
    g_w1 = xb.transpose(1, 2) @ d_h + alpha * w1 / n[:, None, None]
    g_b1 = d_h.sum(dim=1)
    grad = torch.cat([g_w1.reshape(flat.shape[0], -1), g_b1, g_w2, g_b2],
                     dim=1)
    return loss, grad


class MLPClassifier:
    """One classifier over (N, d) rows with sklearn's `predict_proba`
    convention: (N, 2) class probabilities. `fit(x, y, generator)` trains
    one member of `train_members` on tensors of one device."""

    def __init__(self, hidden: int = 64, max_iter: int = 300):
        self.hidden = hidden
        self.max_iter = max_iter
        self.flat = None
        self.n_iter_ = None

    def fit(self, x, y, generator: torch.Generator):
        x = torch.as_tensor(x, dtype=torch.float32)
        self.d_in = x.shape[1]
        self.flat, epochs = train_members(
            x[None], torch.as_tensor(y, device=x.device)[None], [x.shape[0]],
            generator, hidden=self.hidden, max_iter=self.max_iter)
        self.n_iter_ = int(epochs[0])
        return self

    def predict_proba(self, x):
        x = torch.as_tensor(x, dtype=torch.float32, device=self.flat.device)
        p = torch.sigmoid(member_logits(self.flat, x[None], self.d_in,
                                        self.hidden)[0])
        return torch.stack([1.0 - p, p], dim=1)
