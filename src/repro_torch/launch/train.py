"""Training launcher: --arch <id> with checkpoint/restart. Mirrors
``repro.launch.train``, with ``--device``.

Trains the reduced config unless ``--full-config``; on the card,
``--full-config`` trains the published widths of an arch that fits one
H100 (gemma3-1b: 1.0 B parameters, with fp32 params, gradients, moments
and masters about 20 GB). Weights are drawn from seed 0 on the device;
the batches are ``MarkovTokens`` (with stub ``frames``/``patches`` where
the arch takes them).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
        --steps 100 --device cpu

Checkpoints hold ``(params, AdamWState)`` in the reference's layout
(``models.model.params_to_jax`` of the params, ``to_jax_tree`` of each
optimizer leaf),
so either package restores the other's. ``--resume`` restores the newest
checkpoint and moves the token stream on to its step, so a resumed run
sees the batches an uninterrupted run would (the reference's restarts the
stream at its first batch). Runs on the card (``--device cuda``, the
default) unless asked for the CPU. ``main`` returns the run's metrics, the
model and the optimizer state.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config, list_archs, reduced
from repro_torch.data.tokens import TokenSpec, global_batch_iterator
from repro_torch.device import resolve_device
from repro_torch.distributed.fault import HeartbeatTracker
from repro_torch.models import model as M
from repro_torch.train import loop as train_loop
from repro_torch.train import optimizer as opt


def train_tree(model, state: opt.AdamWState, device="cpu") -> tuple:
    """``(params, AdamWState)`` as the reference's train state: the params
    by ``params_to_jax``, each optimizer leaf by ``to_jax_tree``, leaves
    copied to ``device`` (``"meta"``: shapes and dtypes only, a template
    for ``ckpt.restore``)."""
    cfg = model.cfg

    def tree(named):
        return M.to_jax_tree({k: v.detach().to(device)
                              for k, v in named.items()}, cfg)

    return (M.params_to_jax(model, device),
            opt.AdamWState(step=state.step.to(device), mu=tree(state.mu),
                           nu=tree(state.nu), master=tree(state.master)))


def save_train(ckpt_dir: str, step: int, model, state: opt.AdamWState,
               metadata=None) -> str:
    return ckpt.save(ckpt_dir, step, train_tree(model, state),
                     metadata=metadata)


def restore_train(ckpt_dir: str, model, state: opt.AdamWState,
                  step=None) -> tuple:
    """Restore a ``(params, AdamWState)`` checkpoint (written by either
    package) into ``model`` and a new state on the model's device.
    Returns (state, step, metadata)."""
    cfg = model.cfg
    (params, st), step, meta = ckpt.restore(
        ckpt_dir, train_tree(model, state, "meta"), step=step,
        device=model.device)
    named = M.from_jax_tree(params, cfg)
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(named[k])
    state = opt.AdamWState(step=st.step,
                           mu=M.from_jax_tree(st.mu, cfg),
                           nu=M.from_jax_tree(st.nu, cfg),
                           master=M.from_jax_tree(st.master, cfg))
    return state, step, meta


def batch_extras(cfg) -> dict:
    """The stub frontends' inputs a batch carries, as the reference's
    launcher adds them."""
    extras = {}
    if cfg.enc_dec:
        extras["frames"] = (16, cfg.d_model)
    if cfg.frontend == "vision_stub":
        extras["patches"] = (cfg.n_prefix, cfg.d_model)
    return extras


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma3-1b", choices=list_archs())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--full-config", action="store_true",
                    help="use the published config")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = reduced(cfg)
    print(f"arch={cfg.name} layers={cfg.n_layers} d={cfg.d_model} "
          f"pattern={cfg.pattern}")

    adamw = opt.AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                            total_steps=args.steps)
    step_fn = train_loop.make_train_step(cfg, adamw)

    model = M.init_params(0, cfg, device=dev)
    state = opt.init(dict(model.named_parameters()))
    n_params = M.param_count(model)
    print(f"params: {n_params:,}")

    start = 0
    if args.resume and args.ckpt_dir and \
            ckpt.latest_step(args.ckpt_dir) is not None:
        state, start, meta = restore_train(args.ckpt_dir, model, state)
        print(f"resumed from step {start} (meta={meta})")

    data = global_batch_iterator(
        TokenSpec(vocab_size=cfg.vocab_size, batch=args.batch,
                  seq_len=args.seq, seed=0), batch_extras(cfg))
    for _ in range(start):
        next(data)

    hb = HeartbeatTracker(n_hosts=1)
    out = {"losses": [], "grad_norms": [], "lrs": [], "step_s": [],
           "start": start, "params": n_params,
           "tokens_per_step": args.batch * args.seq, "checkpoints": [],
           "ckpt_s": []}
    t_last = time.perf_counter()
    for i, batch in zip(range(start, args.steps), data):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        model, state, metrics = step_fn(model, state, batch)
        loss, gnorm, lr = (float(metrics[k])
                           for k in ("loss", "grad_norm", "lr"))
        now = time.perf_counter()
        hb.record(0, i, now - t_last)
        out["step_s"].append(now - t_last)
        t_last = now
        out["losses"].append(loss)
        out["grad_norms"].append(gnorm)
        out["lrs"].append(lr)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:5d} loss={loss:.4f} gnorm={gnorm:.3f} "
                  f"lr={lr:.2e}")
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            path = save_train(args.ckpt_dir, i + 1, model, state,
                              metadata={"arch": cfg.name})
            out["checkpoints"].append(path)
            t_last = time.perf_counter()
            out["ckpt_s"].append(t_last - now)
            print(f"checkpointed -> {path} in {t_last - now:.1f}s")
        strag = hb.stragglers()
        if strag:
            print(f"stragglers detected: {strag} "
                  "(production: evict + plan_restart)")
    print("done")
    out.update(model=model, state=state)
    return out


if __name__ == "__main__":
    main()
