"""The training loop around the train step: the port's data pipeline
(``repro_torch.data.pipeline``), checkpoints
(``repro_torch.checkpoint.checkpoint``), fault tolerance
(``repro_torch.distributed.fault``) and launcher
(``repro_torch.launch.train``), held against the reference's
(``repro.data``, ``repro.checkpoint``) and its tests
(``tests/test_data_optimizer.py``, ``tests/test_checkpoint.py``).

``synth_batch`` is array-equal to the reference's for the lm, audio and
vlm families.  A checkpoint keeps the reference's on-disk format: one the
reference's ``save`` writes restores in the port equal to
``convert.train_state`` of the same state, leaf for leaf and exactly, and
one the port writes restores in the reference.  On the CPU the launcher
is deterministic, so a resumed run equals an uninterrupted one exactly.
The port runs on ``device="cpu"``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.checkpoint import checkpoint as jckpt
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.data import pipeline as jpipe
from repro.train import optimizer as jopt
from repro.train import train_step as jts

from repro_torch import convert, tree
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import (DataConfig, PrefetchLoader,
                                       device_batch, synth_batch)
from repro_torch.distributed.fault import (ElasticRunner, FaultConfig,
                                           HeartbeatTracker, SimulatedFailure,
                                           StragglerDetector)
from repro_torch.launch import train as launch_train
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts
from test_torch_common import CPU

DENSE = "internlm2-1.8b"
CFG = get_smoke_config(DENSE)


def _equal_trees(a, b):
    la, lb = tree.leaves_with_paths(a), tree.leaves_with_paths(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert torch.equal(x, y), path


# -- data -----------------------------------------------------------------------


@pytest.mark.parametrize("arch", [DENSE, "musicgen-large",
                                  "llama-3.2-vision-90b"])
def test_synth_batch_equals_reference(arch):
    """lm (tokens), audio (frame embeddings), vlm (tokens + frontend),
    on one host and on host 1 of 2."""
    cfg, jcfg = get_smoke_config(arch), j_get_smoke_config(arch)
    for kw in (dict(), dict(num_hosts=2, host_id=1)):
        for step in (0, 7):
            got = synth_batch(cfg, DataConfig(global_batch=4, seq_len=16,
                                              seed=3, **kw), step)
            want = jpipe.synth_batch(jcfg, jpipe.DataConfig(
                global_batch=4, seq_len=16, seed=3, **kw), step)
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_data_deterministic_and_host_sharded():
    full = synth_batch(CFG, DataConfig(global_batch=8, seq_len=16), step=3)
    for hosts in (2, 4):
        parts = [synth_batch(CFG, DataConfig(global_batch=8, seq_len=16,
                                             num_hosts=hosts, host_id=h), 3)
                 for h in range(hosts)]
        np.testing.assert_array_equal(
            np.concatenate([p["tokens"] for p in parts]), full["tokens"])
    assert full["tokens"].shape == full["targets"].shape == (8, 16)
    np.testing.assert_array_equal(full["tokens"][:, 1:],
                                  full["targets"][:, :-1])


def test_device_batch_dtypes():
    """Token ids and targets as int64, frame embeddings and the frontend
    in the activation dtype."""
    for arch in (DENSE, "musicgen-large", "llama-3.2-vision-90b"):
        cfg = get_smoke_config(arch)
        host = synth_batch(cfg, DataConfig(global_batch=2, seq_len=8), 0)
        dev = device_batch(cfg, host, CPU)
        for k, v in dev.items():
            want = torch.int64 if k in ("tokens", "targets") else cfg.adtype
            assert v.dtype == want and v.device.type == "cpu", (arch, k)
            np.testing.assert_array_equal(v.float().numpy(),
                                          torch.from_numpy(host[k])
                                          .to(want).float().numpy())


def test_prefetch_loader():
    loader = PrefetchLoader(CFG, DataConfig(global_batch=2, seq_len=8),
                            start_step=5)
    try:
        step, batch = next(loader)
        assert step == 5 and batch["tokens"].shape == (2, 8)
        np.testing.assert_array_equal(
            batch["tokens"],
            synth_batch(CFG, DataConfig(global_batch=2, seq_len=8), 5)
            ["tokens"])
        step2, _ = next(loader)
        assert step2 == 6
    finally:
        loader.close()


# -- checkpoints ---------------------------------------------------------------


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((4, 8), generator=g),
                       "b": torch.zeros((8,), dtype=torch.bfloat16)},
            "opt": {"step": torch.zeros((), dtype=torch.int32),
                    "m": {"w": torch.ones((4, 8)), "b": torch.zeros((8,))}}}


def test_save_restore_roundtrip(tmp_path):
    s = _state()
    ckpt.save(str(tmp_path), 10, s)
    template = tree.tree_map(lambda t: torch.empty_like(t, device="meta"), s)
    restored, meta = ckpt.restore(str(tmp_path), template)
    assert meta["step"] == 10
    _equal_trees(restored, s)


def test_prune_keeps_latest(tmp_path):
    s = _state()
    for step in [1, 2, 3, 4, 5]:
        ckpt.save(str(tmp_path), step, s, keep=2)
    assert sorted(ckpt.all_steps(str(tmp_path))) == [4, 5]
    assert ckpt.latest_step(str(tmp_path)) == 5
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), s)


def test_async_checkpointer_snapshots_before_writing(tmp_path):
    """The writer thread saves the state as it was at ``save``: the train
    step updates the state in place right after."""
    ac = ckpt.AsyncCheckpointer(str(tmp_path))
    s = _state()
    want = tree.tree_map(torch.clone, s)
    ac.save(7, s)
    s["params"]["w"].add_(1.0)
    ac.wait()
    assert ckpt.latest_step(str(tmp_path)) == 7
    _equal_trees(ckpt.restore(str(tmp_path), want)[0], want)


@pytest.fixture(scope="module")
def ref_state():
    """A reference train state of the bf16 smoke config with compressed
    grads (``ef`` too), every leaf but ``step`` numpy-seeded noise in its
    own dtype, and its config."""
    jcfg = j_get_smoke_config(DENSE)
    tcfg = jts.TrainConfig(opt=jopt.OptConfig(compress_grads=True))
    state = jts.init_train_state(jcfg, tcfg, jax.random.PRNGKey(4))
    rng = np.random.default_rng(4)
    state = jax.tree.map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape), x.dtype), state)
    state["opt"]["step"] = jnp.asarray(3, jnp.int32)
    return state, tcfg


def test_reference_checkpoint_restores_into_port(tmp_path, ref_state):
    state, _ = ref_state
    jckpt.save(str(tmp_path), 1, state)
    tcfg = ts.TrainConfig(opt=opt.OptConfig(compress_grads=True))
    template = ts.abstract_train_state(CFG, tcfg)
    assert all(t.device.type == "meta" for t in tree.leaves(template))
    restored, meta = ckpt.restore(str(tmp_path), template)
    assert meta["step"] == 1 and int(restored["opt"]["step"]) == 3
    _equal_trees(restored, convert.train_state(state, CFG, CPU))


def test_port_checkpoint_restores_into_reference(tmp_path, ref_state):
    state, tcfg = ref_state
    ckpt.save(str(tmp_path), 1, convert.train_state(state, CFG, CPU))
    with np.load(tmp_path / "step_1" / "state.npz") as z:
        assert set(z.files) == set(jckpt._flatten(state))
    template = jax.eval_shape(lambda: state)
    restored, _ = jckpt.restore(str(tmp_path), template)
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(state)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


# -- fault tolerance ---------------------------------------------------------


def test_heartbeat_and_straggler():
    t = {"now": 0.0}
    hb = HeartbeatTracker(4, FaultConfig(heartbeat_timeout_s=10),
                          clock=lambda: t["now"])
    t["now"] = 5.0
    hb.beat(0)
    hb.beat(1)
    t["now"] = 12.0
    assert set(hb.dead_hosts()) == {2, 3}

    sd = StragglerDetector(FaultConfig(step_deadline_factor=3.0))
    for _ in range(5):
        assert not sd.observe(1.0)
    assert sd.observe(10.0)           # 10x the EMA -> straggler
    assert sd.flagged == 1


def test_elastic_runner_recovers_and_matches(tmp_path):
    """The port's train step with failures injected at steps 3 and 5 and a
    checkpoint every 2 steps equals 6 uninterrupted steps exactly (the
    data stream is step-keyed, the step deterministic on the CPU)."""
    cfg = dataclasses.replace(CFG, vocab_size=64)
    tcfg = ts.TrainConfig(opt=opt.OptConfig(lr=1e-3, warmup_steps=2,
                                            total_steps=6))
    dcfg = DataConfig(global_batch=2, seq_len=8)

    def init():
        return ts.init_train_state(cfg, tcfg, torch.Generator().manual_seed(1))

    def step_fn(state, batch):
        return ts.train_step(cfg, tcfg, state, batch)

    def batch_fn(step):
        return device_batch(cfg, synth_batch(cfg, dcfg, step), CPU)

    fcfg = FaultConfig(ckpt_every_steps=2)
    run1 = ElasticRunner(str(tmp_path / "a"), fcfg, step_fn, batch_fn,
                         lambda: ts.abstract_train_state(cfg, tcfg))
    s1, n1 = run1.run(init(), 6)

    fails = {3: True, 5: True}

    def hook(step):
        if fails.pop(step, None):
            raise SimulatedFailure(f"injected at {step}")

    run2 = ElasticRunner(str(tmp_path / "b"), fcfg, step_fn, batch_fn,
                         lambda: ts.abstract_train_state(cfg, tcfg))
    s2, n2 = run2.run(init(), 6, fail_hook=hook)
    assert run2.restarts == 2 and n1 == n2 == 6
    _equal_trees(s2, s1)


# -- the launcher --------------------------------------------------------------


def _launch(tmp, *extra):
    return launch_train.main(["--arch", DENSE, "--smoke", "--global-batch",
                              "2", "--seq", "16", "--ckpt-dir", str(tmp),
                              "--device", CPU, *extra])


def test_launcher_resumes_and_matches_uninterrupted(tmp_path, capsys):
    """4 steps with a checkpoint every 2, then a resume to step 6, equal 6
    uninterrupted steps; 2 microbatches take the same first loss."""
    first = _launch(tmp_path / "a", "--steps", "4", "--ckpt-every", "2")
    assert first.start == 0 and len(first.metrics) == 4
    assert sorted(ckpt.all_steps(str(tmp_path / "a"))) == [2, 4]
    resumed = _launch(tmp_path / "a", "--steps", "6", "--ckpt-every", "2")
    out = capsys.readouterr().out
    assert "[train] elastic resume from step 4" in out
    assert "[train] step 0 loss" in out
    assert "[train] finished at step 6" in out
    assert resumed.start == 4 and len(resumed.metrics) == 2
    whole = _launch(tmp_path / "b", "--steps", "6", "--ckpt-every", "100")
    assert whole.start == 0 and ckpt.all_steps(str(tmp_path / "b")) == []
    _equal_trees(resumed.state, whole.state)
    for got, want in zip(first.metrics + resumed.metrics, whole.metrics):
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    for m in whole.metrics:
        assert np.isfinite(float(m["loss"])) and np.isfinite(
            float(m["grad_norm"]))
    assert float(whole.metrics[5]["lr"]) == pytest.approx(
        opt.lr_at(whole.tcfg.opt, 6), rel=1e-6)
    two = _launch(tmp_path / "c", "--steps", "1", "--microbatches", "2")
    np.testing.assert_allclose(float(two.metrics[0]["loss"]),
                               float(whole.metrics[0]["loss"]), rtol=1e-5)


@pytest.mark.parametrize("flags", [["--tp", "2"], ["--dp", "2"],
                                   ["--production-mesh"], ["--multi-pod"]])
def test_launcher_refuses_the_mesh(tmp_path, flags):
    """The mesh flags as the reference's launcher reads them: ``--tp 2`` /
    ``--dp 2`` train on 2 spawned gloo ranks, their first loss (the same
    weights, the global batch) one device's; the production meshes need
    256 / 512 ranks and refuse a lone process, naming the count."""
    if flags[0] in ("--tp", "--dp"):
        run = _launch(tmp_path / "mesh", "--steps", "1", *flags)
        one = _launch(tmp_path / "one", "--steps", "1")
        assert run.start == 0 and len(run.metrics) == 1
        np.testing.assert_allclose(float(run.metrics[0]["loss"]),
                                   float(one.metrics[0]["loss"]), rtol=1e-6)
        return
    need = "512" if flags == ["--multi-pod"] else "256"
    with pytest.raises(RuntimeError, match=f"needs {need} ranks"):
        _launch(tmp_path, "--steps", "1", *flags)
    assert ckpt.all_steps(str(tmp_path)) == []


def test_launcher_defaults_to_cuda_and_raises_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--arch", DENSE, "--smoke", "--steps", "1",
                           "--ckpt-dir", str(tmp_path)])
