"""The ``train_step`` entry: the train step of ``make_train_step``, called once
per microbatch as ``BaseRunner.train`` calls it, with the template's
accumulation, optimizer, plateau and EMA.

The traffic file gives ``batch``, ``accumulate``, ``pool`` (image pairs held
on the card), ``compared_updates``, the window update that is checked
(``check_update_from`` plus a number under ``check_update_span`` that the
seed draws) and the traced slice (``trace_start`` and
``trace_microbatches``, counted from the window's first microbatch).
Microbatch ``i`` takes pool rows ``i * batch ...`` (mod the pool) and its own
timesteps and noise, drawn on the card from the seed and handed to the step
through ``t=`` and ``noise=``.

Set-up builds the runner's train state once and drives it through its first
``compared_updates`` updates with the window's own call and feed, on rows
that all differ; they are the warm-up, and the same state goes on into the
window. The window runs whole updates: none starts after ``--seconds``, and
it runs on past them only until the checked update is done, which a sound
run reaches in well under half the window. Around the checked update the
window copies the trainable leaves and Adam's moments to pinned host memory
(before it: leaves, both moments; after it: leaves, first moment).

After the window the reference (float32, TF32 off) judges two stretches:

* the start: it follows the first ``compared_updates`` updates from the same
  weights and inputs on its own (its loss, autograd's gradient summed over
  the microbatches of an update, Adam and the plateau's learning rate);
* the checked window update: it takes the program's leaves and moments from
  before that update (it can only follow the program there from the
  program's own state), the plateau's learning rate from the program's
  losses, and makes the update itself.

Printed and not compared: each microbatch's loss gap, ``|loss - loss_ref| /
loss_ref``, and the checked window update's gradient gap: no control or
fault reading separates them from sound runs (PERF.md). Numbers compared:

* ``grad_norm_gap`` (the start): over the trainable leaves, the largest gap
  between the norm of the first update's gradient as Adam got it (worked
  out from its first moment, ``mu / (1 - beta1)``) and the reference's, over
  the larger of that leaf's reference norm and the median leaf's (the
  window update's is ``(mu - beta1 mu_before) / (1 - beta1)``);
* ``update_norm_gap`` (the start) and ``window_update_norm_gap`` (the
  checked update): the same of each leaf's change over the stretch.

A gradient that is nought up to rounding in the reference moves its
parameter under Adam by round-off alone (each first step is +-lr whatever
the gradient's size). So the gradient gap leaves out a leaf whose reference
gradient norm is under a thousandth of the median leaf's, and the change
leaves out each element whose reference gradient is under a thousandth of
the median leaf's root mean square (the key's third of an attention's fused
``qkv`` bias, whose gradient softmax cancels, is such a part of a leaf).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark import flops, traffic as T
from benchmark.entries.common import Profiler, build_runner, reference_weights, release
from benchmark.reference import model as R
from benchmark.reference.train import Adam, Plateau
from benchmark.roofline import kernel_calls, scaled
from benchmark.trace import Spans

TINY_GRAD = 1e-3


def _pool(seed, n, size, device):
    pairs = [T.make_pair(T.pair_seed(seed, (1 << 20) + i), size) for i in range(n)]
    to = lambda k: torch.from_numpy(np.stack([p[k] for p in pairs])).permute(0, 3, 1, 2)
    return to(0).contiguous().to(device), to(1).contiguous().to(device)


def _feed(st, i):
    """(x, y, t, noise) of microbatch ``i``."""
    B, (x_pool, y_pool) = st["batch"], st["pool"]
    rows = torch.arange(i * B, (i + 1) * B, device=x_pool.device) % x_pool.shape[0]
    bb = st["cfg"]["model"]["BB"]["params"]
    t = T.timesteps(st["seed"], i, B, bb["num_timesteps"], x_pool.device)
    noise = T.noise(st["seed"], i, (B, *st["latent_shape"]), x_pool.device)
    return x_pool[rows], y_pool[rows], t, noise


def check_update(seed, traffic) -> int:
    """The window update that a run with ``seed`` checks, counted from 0."""
    rng = np.random.RandomState(T.pair_seed(seed, 0x55504454))
    return traffic["check_update_from"] + int(rng.randint(traffic["check_update_span"]))


class Snapshot:
    """Host copies, in pinned memory made in set-up, of the trainable leaves
    and Adam's moments before (``theta0``, ``mu0``, ``nu0``) and after
    (``theta1``, ``mu1``) one update."""

    KEYS = ("theta0", "mu0", "nu0", "theta1", "mu1")

    def __init__(self, params):
        pin = torch.cuda.is_available() and params[0].is_cuda
        n = sum(p.numel() for p in params)
        self.views = {}
        for k in self.KEYS:
            flat = torch.empty(n, dtype=torch.float32, pin_memory=pin)
            out, o = [], 0
            for p in params:
                out.append(flat[o:o + p.numel()].view(p.shape))
                o += p.numel()
            self.views[k] = out
        self.taken = set()

    def take(self, **tensors):
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # whatever stream the program updates on
        for k, ts in tensors.items():
            for dst, src in zip(self.views[k], ts):
                dst.copy_(src.detach(), non_blocking=True)
            self.taken.add(k)


def setup(ctx):
    tr, device, seed = ctx["traffic"], ctx["device"], ctx["seed"]
    runner, cfg, specs = build_runner(ctx["config"], tr, seed, device)
    vq = cfg["model"]["VQGAN"]["params"]
    lat = vq["ddconfig"]["resolution"] // 2 ** (len(vq["ddconfig"]["ch_mult"]) - 1)
    size = cfg["data"]["dataset_config"]["image_size"]
    st = dict(runner=runner, cfg=cfg, specs=specs, seed=seed, batch=tr["batch"],
              latent_shape=(vq["embed_dim"], lat, lat), spans=Spans(),
              pool=_pool(seed, tr["pool"], size, device))
    runner.state = runner.build_initial_state()
    st["step"] = runner.build_train_step()
    runner.model.train()
    state, acc = runner.state, tr["accumulate"]
    opt = state.optimizer
    st["snap"], st["check_update"] = Snapshot(opt.params), check_update(seed, tr)
    losses = []
    for i in range(tr["compared_updates"] * acc):
        x, y, t, noise = _feed(st, i)
        losses.append(st["step"](state, x, y, t=t, noise=noise)["loss"])
        if i + 1 == acc:
            b1 = float(np.float32(opt.b1))
            grad = torch.stack(torch._foreach_norm(opt.state["mu"])) / (1 - b1)
    st.update(losses=torch.stack(losses).tolist(), grad=grad.tolist(), names=list(opt.names),
              theta=[p.detach().to("cpu", copy=True) for p in opt.params], next=len(losses))
    if device.type == "cuda":
        torch.cuda.synchronize()
    return st


def window(st, ctx):
    tr, device = ctx["traffic"], ctx["device"]
    runner, step, acc = st["runner"], st["step"], tr["accumulate"]
    state, spans, cfg = runner.state, st["spans"], st["cfg"]
    opt, snap, u = runner.state.optimizer, st["snap"], st["check_update"]
    start, prof, losses = st["next"], None, []
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
    opened = time.perf_counter()
    i = start
    while (i - start) % acc or time.perf_counter() - opened < ctx["seconds"] \
            or (i - start) // acc <= u:
        k = i - start
        if ctx["trace"] and k == tr["trace_start"]:
            spans.begin_traced()
            prof = Profiler(device)
            prof.start()
        if k == u * acc:
            snap.take(theta0=opt.params, mu0=opt.state["mu"], nu0=opt.state["nu"])
        with spans("feed"):
            x, y, t, noise = _feed(st, i)
        with spans("microbatch"):
            losses.append(step(state, x, y, t=t, noise=noise)["loss"])
        if k == u * acc + acc - 1:
            snap.take(theta1=opt.params, mu1=opt.state["mu"])
        i += 1
        if prof is not None and k + 1 == tr["trace_start"] + tr["trace_microbatches"]:
            prof.stop()
            spans.end_traced()
            st["traced"], prof = prof, None
    if device.type == "cuda":
        torch.cuda.synchronize()
    window_s = time.perf_counter() - opened
    mb = i - start
    mb_flops = tr["batch"] * flops.train_image(cfg["model"])
    st["window_losses"] = torch.stack(losses).tolist()
    obs = dict(window_s=window_s, microbatches=mb, images=mb * tr["batch"], attempted=mb,
               failed=int(sum(not np.isfinite(v) for v in st["window_losses"])), spans=spans,
               flops=mb * mb_flops, untraced_s=window_s - spans.traced_s(),
               untraced_flops=(mb - (tr["trace_microbatches"] if spans.traced else 0)) * mb_flops,
               peak_bytes=torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0)
    if ctx["trace"]:
        if "traced" not in st:
            raise RuntimeError("the window ended before the traced slice did")
        sliced = st.pop("traced").reduce()
        calls = kernel_calls(cfg["model"], tr["batch"])
        unet = type(calls["unet"])({k: n for k, n in calls["unet"].items()
                                    if k[0] != "upsample_conv"})  # training: plain up-convs
        sliced["calls"] = scaled(scaled(calls["encoder"], 2) + unet, tr["trace_microbatches"])
        sliced["elsize"] = 2 if cfg["model"].get("mixed_precision", True) else 4
        obs["trace"] = sliced
    return obs


def reference_run(st, ctx, ops=None):
    """The reference over the compared updates from the weights and feed of
    ``st``: {losses, grad (first update's gradient per leaf), theta0, theta
    (the leaves after the last compared update), before (its leaves and
    Adam's moments then, as :func:`follow_update` takes them)}."""
    tr, device = ctx["traffic"], ctx["device"]
    P = reference_weights(st["specs"], st["seed"], device)
    theta0 = [P.weights[k].clone() for k in st["names"]]
    params = [P.weights[k].requires_grad_() for k in st["names"]]
    opt_cfg, sched = st["cfg"]["model"]["BB"]["optimizer"], st["cfg"]["model"]["BB"]["lr_scheduler"]
    adam, plateau = Adam(params, opt_cfg), Plateau(opt_cfg["lr"], sched)
    losses, grad = [], None
    acc = tr["accumulate"]
    for i in range(tr["compared_updates"] * acc):
        x, y, t, noise = _feed(st, i)
        loss = R.train_loss(P, ops or R.Ops(), x, y, t, noise, st["cfg"]["model"])
        loss.backward()
        losses.append(float(loss.detach()))
        if (i + 1) % acc == 0:
            if grad is None:
                grad = [p.grad.clone() for p in params]
            adam.update([p.grad for p in params], plateau.lr)
            plateau.step(losses[-1])
            for p in params:
                p.grad = None
    theta = [p.detach() for p in params]
    return dict(losses=losses, grad=grad, theta0=theta0, theta=theta,
                before=dict(theta=theta, mu=adam.mu, nu=adam.nu))


def follow_update(st, ctx, before, count, lr, first, ops=None):
    """The reference's own update from ``before`` ({theta, mu, nu}: each
    trainable leaf and Adam's moments, after ``count`` updates) at the
    learning rate ``lr``, over the microbatches ``first ...`` of the feed:
    {losses, grad (the summed gradient per leaf), theta0, theta}."""
    tr, device = ctx["traffic"], ctx["device"]
    P = reference_weights(st["specs"], st["seed"], device)
    for k, v in zip(st["names"], before["theta"]):
        P.weights[k] = v.to(device, torch.float32, copy=True)
    params = [P.weights[k].requires_grad_() for k in st["names"]]
    theta0 = [p.detach().clone() for p in params]
    adam = Adam(params, st["cfg"]["model"]["BB"]["optimizer"])
    adam.mu = [m.to(device, torch.float32, copy=True) for m in before["mu"]]
    adam.nu = [m.to(device, torch.float32, copy=True) for m in before["nu"]]
    adam.count = count
    losses = []
    for i in range(first, first + tr["accumulate"]):
        x, y, t, noise = _feed(st, i)
        loss = R.train_loss(P, ops or R.Ops(), x, y, t, noise, st["cfg"]["model"])
        loss.backward()
        losses.append(float(loss.detach()))
    grad = [p.grad.clone() for p in params]
    adam.update([p.grad for p in params], lr)
    return dict(losses=losses, grad=grad, theta0=theta0, theta=[p.detach() for p in params])


def checked_update(st, ctx):
    """The program's checked window update: (before, count, lr, first) as
    :func:`follow_update` takes them, the plateau's learning rate worked out
    from the program's losses, and what the program made of it: {losses,
    grad (norm per leaf, from Adam's first moment), theta}."""
    tr, device = ctx["traffic"], ctx["device"]
    acc, u, snap = tr["accumulate"], st["check_update"], st["snap"]
    if set(snap.taken) != set(Snapshot.KEYS):
        raise RuntimeError(f"the window did not reach checked update {u}")
    count = tr["compared_updates"] + u
    losses = st["losses"] + st["window_losses"]
    sched, lr = st["cfg"]["model"]["BB"]["lr_scheduler"], st["cfg"]["model"]["BB"]["optimizer"]["lr"]
    plateau = Plateau(lr, sched)
    for q in range(count):
        plateau.step(losses[(q + 1) * acc - 1])
    b1 = np.float32(st["cfg"]["model"]["BB"]["optimizer"].get("beta1", 0.9))
    v = snap.views
    grad = [float(((m1.to(device) - m0.to(device) * b1) / np.float32(1 - b1)).norm())
            for m0, m1 in zip(v["mu0"], v["mu1"])]
    before = dict(theta=v["theta0"], mu=v["mu0"], nu=v["nu0"])
    first = st["next"] + u * acc
    prog = dict(losses=st["window_losses"][u * acc:(u + 1) * acc], grad=grad, theta=v["theta1"])
    return (before, count, plateau.lr, first), prog


def compare(prog: dict, ref: dict) -> dict:
    """The three gaps of ``prog`` ({losses, grad: norms per leaf, theta})
    against ``ref`` (a :func:`reference_run`), and the worst leaves' indices."""
    g_ref = [float(g.norm()) for g in ref["grad"]]
    keep = np.asarray(g_ref) >= TINY_GRAD * np.median(g_ref)
    rms = np.median([n / g.numel() ** 0.5 for n, g in zip(g_ref, ref["grad"])])
    d_ref, d_prog = [], []
    for g, t0, tr_, tp in zip(ref["grad"], ref["theta0"], ref["theta"], prog["theta"]):
        mask = g.abs() >= TINY_GRAD * rms
        d_ref.append(float((tr_ - t0)[mask].norm()))
        d_prog.append(float((tp.to(t0.device) - t0)[mask].norm()))
    moved = np.asarray(d_ref) > 0
    gaps = lambda p, r, k: np.where(k, np.abs(np.asarray(p) - np.asarray(r))
                                    / np.maximum(np.asarray(r), np.median(np.asarray(r)[k])), 0)
    grad_gaps, change_gaps = gaps(prog["grad"], g_ref, keep), gaps(d_prog, d_ref, moved)
    return {"loss_rel_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])),
            "grad_norm_gap": float(grad_gaps.max()), "update_norm_gap": float(change_gaps.max()),
            "worst": (int(grad_gaps.argmax()), int(change_gaps.argmax()))}


def check(st, obs, ctx, limits):
    runner = st.pop("runner")
    del runner, st["step"]
    release()
    gaps = compare(st, reference_run(st, ctx))
    release()
    args, prog = checked_update(st, ctx)
    window = compare(prog, follow_update(st, ctx, *args))
    for name, g in (("start", gaps), (f"window update {st['check_update']}", window)):
        print("{}: worst leaves: gradient {}, change {}; loss_rel_gap (not compared) {!r}".format(
            name, *(st["names"][i] for i in g["worst"]), g["loss_rel_gap"]), file=sys.stderr)
    gaps["window_update_norm_gap"] = window["update_norm_gap"]
    print(f"window_grad_norm_gap (not compared) {window['grad_norm_gap']!r}", file=sys.stderr)
    return [(k, gaps[k], limits[k]) for k in ("grad_norm_gap", "update_norm_gap",
                                              "window_update_norm_gap")]
