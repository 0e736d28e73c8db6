"""Decode drift of the LM serving path, the port beside the reference.

For one arch at its published widths (depth cut with ``--layers``), the
reference (``repro.models``, JAX on the CPU) draws the weights from
``--seed`` and ``params_from_jax`` hands them to the port
(``repro_torch.models``, on the CPU). A numpy prompt of ``--prompt``
tokens (and, for whisper, ``--frames`` audio-stub frames) is prefilled and
``--steps`` tokens are decoded, teacher-forced. It prints three numbers,
each the largest |difference| of the logits over the batch, the vocabulary
and the positions from the prompt's last to the last step's:

  1. the reference's own drift: its ``prefill`` + ``decode_step`` logits
     against its ``forward`` logits at the same positions;
  2. the port's drift, measured the same way;
  3. the port's prefill and decode logits against the reference's, step
     by step.

MoE archs run at ``moe_capacity_factor=8.0`` (no token is dropped), as
``tests/test_models.py``'s serving check does. The last line is a JSON
object with every number. Run one arch at a time:

    JAX_PLATFORMS=cpu PYTHONPATH=src python scripts/lm_drift.py \\
        --arch gemma3-1b --layers 6 --prompt 576 --steps 8

Memory: two fp32 copies of the weights (one a package) and the logits of
the compared positions; ``--layers`` keeps the encoder's and the
decoder's depth at that many layers.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import resource
import time

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.models import model as M


def configs(arch: str, layers: int | None):
    """The reference's and the port's config: published widths, the depth
    cut to ``layers`` where given, MoE at capacity 8.0."""
    out = []
    for cfg in (jget_config(arch), get_config(arch)):
        changes = {}
        if layers is not None:
            changes["n_layers"] = min(layers, cfg.n_layers)
            if cfg.enc_dec:
                changes["n_enc_layers"] = min(layers, cfg.n_enc_layers)
        if cfg.is_moe:
            changes["moe_capacity_factor"] = 8.0
        out.append(dataclasses.replace(cfg, **changes))
    return out


def make_batch(cfg, b: int, prompt: int, steps: int, frames: int,
               seed: int) -> dict:
    r = np.random.default_rng(seed)
    batch = {"tokens": r.integers(0, cfg.vocab_size, (b, prompt + steps))
             .astype(np.int32)}
    if cfg.enc_dec:
        batch["frames"] = r.normal(size=(b, frames, cfg.d_model)) \
            .astype(np.float32)
    if cfg.frontend == "vision_stub":
        batch["patches"] = r.normal(size=(b, cfg.n_prefix, cfg.d_model)) \
            .astype(np.float32)
    return batch


def n_prefix(cfg) -> int:
    return cfg.n_prefix if cfg.frontend == "vision_stub" else 0


def reference_run(jcfg, params, batch, prompt, steps):
    """(forward logits at the compared positions, prefill + decode logits),
    each (b, steps + 1, V) fp32 numpy."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    lo = n_prefix(jcfg) + prompt - 1
    fwd = jax.jit(lambda p, b: JM._logits(
        p, jcfg, JM.forward_hidden(p, jcfg, b)[:, lo:]))(params, jb)
    max_len = n_prefix(jcfg) + prompt + steps
    pb = dict(jb, tokens=jb["tokens"][:, :prompt])
    lp, cache = jax.jit(lambda p, b: JM.prefill(p, jcfg, b, max_len))(
        params, pb)
    decode = jax.jit(lambda p, t, c: JM.decode_step(p, jcfg, t, c))
    out = [lp[:, 0]]
    for t in range(prompt, prompt + steps):
        lg, cache = decode(params, jb["tokens"][:, t:t + 1], cache)
        out.append(lg[:, 0])
    return (np.asarray(fwd, np.float32),
            np.asarray(jnp.stack(out, axis=1), np.float32))


@torch.no_grad()
def port_run(model, batch, prompt, steps):
    """The same two, from the port on the CPU."""
    cfg = model.cfg
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    lo = n_prefix(cfg) + prompt - 1
    fwd = M._logits(model, M.forward_hidden(model, tb)[:, lo:])
    max_len = n_prefix(cfg) + prompt + steps
    lp, cache = M.prefill(model, dict(tb, tokens=tb["tokens"][:, :prompt]),
                          max_len)
    out = [lp[:, 0]]
    for t in range(prompt, prompt + steps):
        lg, cache = M.decode_step(model, tb["tokens"][:, t:t + 1], cache)
        out.append(lg[:, 0])
    return fwd.numpy(), torch.stack(out, dim=1).numpy()


def by_position(a, b):
    return np.abs(a - b).max(axis=(0, 2))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (default: all)")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt", type=int, default=576)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--frames", type=int, default=1500)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    jcfg, cfg = configs(args.arch, args.layers)
    params = JM.init_params(jax.random.PRNGKey(args.seed), jcfg)
    batch = make_batch(cfg, args.batch, args.prompt, args.steps,
                       args.frames, args.seed)
    ref_fwd, ref_dec = reference_run(jcfg, params, batch, args.prompt,
                                     args.steps)
    t_ref = time.perf_counter() - t0
    model = M.params_from_jax(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    del params
    n_params = M.param_count(model)
    t1 = time.perf_counter()
    fwd, dec = port_run(model, batch, args.prompt, args.steps)
    t_port = time.perf_counter() - t1
    res = {
        "arch": cfg.name, "n_layers": cfg.n_layers,
        "n_enc_layers": cfg.n_enc_layers, "params": n_params,
        "batch": args.batch, "prompt": args.prompt, "steps": args.steps,
        "frames": args.frames if cfg.enc_dec else 0, "seed": args.seed,
        "moe_capacity_factor": cfg.moe_capacity_factor if cfg.is_moe
        else None,
        "reference_drift": by_position(ref_dec, ref_fwd).tolist(),
        "port_drift": by_position(dec, fwd).tolist(),
        "port_vs_reference": by_position(dec, ref_dec).tolist(),
        "forward_port_vs_reference": by_position(fwd, ref_fwd).tolist(),
        "reference_s": t_ref, "port_s": t_port,
        "max_rss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        / 1e6,
    }
    print(f"{cfg.name}: {cfg.n_layers} layers"
          + (f" + {cfg.n_enc_layers} encoder layers" if cfg.enc_dec else "")
          + f" of {jget_config(args.arch).n_layers} at the published widths "
          f"(d_model {cfg.d_model}, vocab {cfg.vocab_size}), {n_params:,} "
          f"parameters; {args.batch} x {args.prompt} prompt tokens, "
          f"{args.steps} steps")
    for key, what in (("reference_drift", "1. the reference's own drift"),
                      ("port_drift", "2. the port's drift"),
                      ("port_vs_reference", "3. port vs reference, decode"),
                      ("forward_port_vs_reference",
                       "   port vs reference, forward")):
        v = res[key]
        print(f"{what}: max {max(v):.4f}; by position "
              f"{[round(e, 4) for e in v]}")
    print(f"reference {t_ref:.1f} s, port {t_port:.1f} s, max RSS "
          f"{res['max_rss_gb']:.1f} GB")
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
