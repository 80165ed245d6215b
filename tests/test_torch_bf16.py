"""The bf16 serve path of both packages against each other and against
their own ``forward``: the port's ``models/`` and the reference's on the
same bfloat16 weights (``convert.model_params`` keeps each leaf's dtype).

``serve_gap`` runs ``forward`` over B × (S + 2) tokens, then ``prefill``
of S and two ``decode_step``s, on both packages, and returns per step the
ratio of |serve − forward| to the reference test's bound 6e-2 + 6e-2 ·
|logit| (``tests/test_models_smoke.py``) on each package, and the largest
|port − reference| of the served logits.  The test runs it on the
``internlm2-1.8b`` smoke config; run as a script it measures the same at
full width with the depth given (cut, to keep a CPU run small)::

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/test_torch_bf16.py \\
        --arch internlm2-1.8b --layers 2 4 8

A MoE runs dropless (``dropless``), as the reference's smoke config and
``chip_smoke.py``'s check do.
"""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro  # noqa: F401
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import transformer as jtf

from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import transformer as tf

BOUND = 6e-2


def _ratio(served, full) -> float:
    return float((np.abs(served - full) / (BOUND + BOUND * np.abs(full)))
                 .max())


def dropless(cfg):
    """A MoE config at capacity factor E/k, where no (token, expert) pair
    is dropped: below it the drops depend on a group's tokens, so the
    serve path is not the train path in either package."""
    if cfg.capacity_factor * cfg.experts_per_token < cfg.num_experts:
        return dataclasses.replace(
            cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)
    return cfg


def serve_gap(jcfg, tcfg, seed: int = 1, B: int = 2, S: int = 16) -> dict:
    """Both packages' bf16 serve path on the same weights and tokens."""
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = convert.model_params(jp, tcfg, "cpu")
    tokens = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, size=(B, S + 2)).astype(np.int32)
    jt = jnp.asarray(tokens)
    tt = torch.from_numpy(tokens.astype(np.int64))

    jfull = np.asarray(jtf.forward(jcfg, jp, jt)[0])
    cache = jtf.init_cache(jcfg, B, S + 8)
    lg, cache = jtf.prefill(jcfg, jp, jt[:, :S], cache)
    jsteps = [np.asarray(lg)[:, 0]]
    for i in range(2):
        lg, cache = jtf.decode_step(jcfg, jp, jt[:, S + i:S + i + 1], cache,
                                    S + i)
        jsteps.append(np.asarray(lg)[:, 0])
    del jp, cache

    tfull = tf.forward(tcfg, tp, tt)[0].numpy()
    cache = tf.init_cache(tcfg, B, S + 8, device="cpu")
    lg, cache = tf.prefill(tcfg, tp, tt[:, :S], cache)
    tsteps = [lg[:, 0].numpy()]
    for i in range(2):
        lg, cache = tf.decode_step(tcfg, tp, tt[:, S + i:S + i + 1], cache,
                                   S + i)
        tsteps.append(lg[:, 0].numpy())

    cols = [S - 1, S, S + 1]
    return {
        "ref_ratio": [_ratio(s, jfull[:, c]) for s, c in zip(jsteps, cols)],
        "port_ratio": [_ratio(s, tfull[:, c]) for s, c in zip(tsteps, cols)],
        "port_vs_ref": [float(np.abs(t - j).max())
                        for t, j in zip(tsteps, jsteps)],
        "forward_port_vs_ref": float(np.abs(tfull - jfull).max()),
        "max_logit": float(np.abs(jfull).max()),
    }


def test_bf16_serve_path_equals_reference_smoke():
    """The ``internlm2-1.8b`` smoke config in bfloat16: each package's
    serve path within the reference test's bound of its own ``forward``,
    and the port's served logits within bf16 rounding of the
    reference's."""
    jcfg = j_get_smoke_config("internlm2-1.8b")
    tcfg = get_smoke_config("internlm2-1.8b")
    assert jcfg.dtype == tcfg.dtype == "bfloat16"
    gap = serve_gap(jcfg, tcfg)
    assert max(gap["ref_ratio"]) <= 1 and max(gap["port_ratio"]) <= 1, gap
    # a few ulps of bf16 at the logits' magnitude (|logit| < 8: 2^-5)
    assert max(gap["port_vs_ref"]) <= 2 ** -4, gap
    assert gap["forward_port_vs_ref"] <= 2 ** -4, gap


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--layers", type=int, nargs="+", default=[2])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1])
    args = ap.parse_args(argv)
    for n in args.layers:
        jcfg = dropless(dataclasses.replace(j_get_config(args.arch),
                                            num_layers=n))
        tcfg = dropless(dataclasses.replace(get_config(args.arch),
                                            num_layers=n))
        for seed in args.seeds:
            gap = serve_gap(jcfg, tcfg, seed=seed)
            print(f"{args.arch} d {tcfg.d_model}, {n} layers, {tcfg.dtype}, "
                  f"seed {seed}: ratio to {BOUND} + {BOUND}·|logit| "
                  f"(prefill, decode 1, decode 2) reference "
                  f"{['%.3f' % r for r in gap['ref_ratio']]}, port "
                  f"{['%.3f' % r for r in gap['port_ratio']]}; served "
                  f"max|port - reference| "
                  f"{['%.3e' % d for d in gap['port_vs_ref']]}, forward "
                  f"{gap['forward_port_vs_ref']:.3e} (max|logit| "
                  f"{gap['max_logit']:.3f})", flush=True)


if __name__ == "__main__":
    main()
