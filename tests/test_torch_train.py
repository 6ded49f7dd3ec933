"""The port's YOLO training (rtvm_tpu_torch.models.yolo.train, optim,
train_synth, utils.checkpoint's writer) against the JAX package's, float32
on the CPU.

Tolerances (float32; the two packages sum convolutions in other orders):
- yolo_loss: relative 1e-5 (measured 1.5e-7 for YOLOv8n, 7.9e-7 for
  YOLO11n); its gradients: relative L2 per leaf 1e-3 (measured 2.4e-5 and
  6.3e-5) for every leaf whose gradient norm is above 1e-6 of the global
  norm; the others (BatchNorm biases whose gradient is zero but for
  rounding: a per-channel constant before the next training-mode
  BatchNorm) within 1e-6 of the global norm;
- BatchNorm running statistics after one training-mode forward: |d| <=
  1e-5 (1 + |value|) (measured 1.6e-7 and 2.4e-7);
- parameters after 1 and 3 AdamW steps: |d| <= 1e-5 on at least 0.999 of
  the values (measured 0.99996 after one step; Adam's first steps move a
  weight whose gradient is noise-sized by about the rate either way), and
  nowhere more than twice the rate a step; the moments mu and nu within 1e-4 (1 + |value|) of
  optax's on 0.999 of the values, the counts equal;
- the learning rate at every count of a 40-step run: relative 1e-6 of
  optax's (float32);
- train_synth.train end to end (3 steps, batch 2, imgsz 64, the same JAX
  weights and JAX's batches in both; see ``train_runs`` for why not Flax's
  random init): the written files' structure byte-equal, the moments and
  counts as above, the parameters within 1e-5 on at least 0.997 of the
  values (measured 0.99843: at 64 px the stride-32 maps are 2x2, so their
  training-mode BatchNorm averages 8 values and those layers' gradients
  carry the most rounding), the BatchNorm statistics within 1e-3 (1 +
  |value|) (measured 1.1e-4), the reports' mAP within 0.05 (bf16
  inference).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rtvm_tpu.models.yolo import model as JM
from rtvm_tpu.models.yolo import synth as JS
from rtvm_tpu.models.yolo import train as JT
from rtvm_tpu.models.yolo import train_synth as JTS
from rtvm_tpu.utils import checkpoint as JC
from rtvm_tpu_torch.models import optim as TO
from rtvm_tpu_torch.models.yolo import model as TM
from rtvm_tpu_torch.models.yolo import train as TT
from rtvm_tpu_torch.models.yolo import train_synth as TTS
from rtvm_tpu_torch.models.yolo.convert import (flatten_tree, flax_to_state_dict, torch_to_flax,
                                                torch_to_flax_arrays)
from rtvm_tpu_torch.utils import checkpoint as TC

torch.set_num_threads(1)  # tier 1 runs several test workers at once

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-3
GRAD_NOISE = 1e-6  # of the global norm: a leaf below it has no gradient but rounding
BN_TOL = 1e-5
PARAM_ATOL, PARAM_SHARE = 1e-5, 0.999
E2E_SHARE = 0.997  # the trainers' 3 steps at 64 px: stride-32 maps of 2x2
STATS_TOL = 1e-3  # BatchNorm statistics after those 3 steps, of 1 + |value|
MOMENT_TOL = 1e-4
SCHED_RTOL = 1e-6
MAP_TOL = 0.05
NC = 8
CHECKPOINTS = {"yolov8n": "weights/yolov8n_aerial.npz", "yolo11n": "weights/yolo11n_aerial.npz"}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _checkpoint(variant):
    """(JAX model, JAX variables as numpy, the port's model on the CPU) of a
    bundled checkpoint; JAX's structure without an init."""
    flat = TC.load_pytree_npz(CHECKPOINTS[variant])
    jm = JM.YOLOv8(JM.YoloConfig(variant=variant, num_classes=NC))
    tm = TM.build_yolo(variant, num_classes=NC, device="cpu")
    tm.load_state_dict(flax_to_state_dict(flat, variant))
    return jm, TC.flat_to_nested(flat), tm


def _targets():
    """Two images' targets at 64 px with sub-cell 'person' boxes (class 0)
    that no anchor center falls inside, one padded slot."""
    boxes = np.array([[[4, 4, 12, 13], [20, 30, 50, 60], [30.5, 2, 36, 8], [0, 0, 0, 0]],
                      [[10, 10, 18, 18], [2, 2, 60, 60], [40, 40, 44, 47], [1, 1, 5, 5]]],
                     np.float32)
    cls = np.array([[0, 4, 0, 0], [0, 1, 2, 3]], np.int32)
    valid = np.array([[1, 1, 1, 0], [1, 1, 1, 1]], bool)
    return boxes, cls, valid


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nchw(a):
    return _t(np.moveaxis(a, -1, 1))


def _close_share(got, want, atol):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    return float((d <= atol).mean()), float(d.max())


@pytest.fixture(scope="module", params=sorted(CHECKPOINTS))
def loss_pair(request):
    """One training-mode loss and its gradients in both packages, from the
    bundled checkpoint, on the same images and targets."""
    variant = request.param
    jm, jv, tm = _checkpoint(variant)
    imgs = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    boxes, cls, valid = _targets()
    tg = JT.Targets(jnp.asarray(boxes), jnp.asarray(cls), jnp.asarray(valid))

    @jax.jit
    def value_and_grad(params, batch_stats):
        def lf(p):
            return JT.yolo_loss(jm, {"params": p, "batch_stats": batch_stats}, jnp.asarray(imgs),
                                tg, train=True)

        return jax.value_and_grad(lf, has_aux=True)(params)

    (jl, (mutated, jmet)), jg = value_and_grad(jv["params"], jv["batch_stats"])
    tl, tmet = TT.yolo_loss(tm, _nchw(imgs), TT.Targets(_t(boxes), _t(cls), _t(valid)))
    tl.backward()
    return dict(variant=variant, jax_loss=float(jl), jax_pos=float(jmet["num_pos"]),
                jax_grads=flatten_tree({"params": _np_tree(jg)}),
                jax_stats=flatten_tree({"batch_stats": _np_tree(mutated["batch_stats"])}),
                loss=float(tl), pos=float(tmet["num_pos"]),
                grads=torch_to_flax_arrays({k: p.grad for k, p in tm.named_parameters()}),
                stats=torch_to_flax_arrays(dict(tm.named_buffers())))


def test_yolo_loss_and_gradients_match_jax(loss_pair):
    p = loss_pair
    assert p["pos"] == p["jax_pos"] >= 5  # the person boxes were assigned too
    assert abs(p["loss"] - p["jax_loss"]) <= LOSS_RTOL * abs(p["jax_loss"])
    want, got = p["jax_grads"], p["grads"]
    assert sorted(got) == sorted(want)
    gnorm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in want.values()))
    for k, g in want.items():
        n = np.linalg.norm(g)
        err = np.linalg.norm(got[k] - g)
        if n > GRAD_NOISE * gnorm:
            assert err <= GRAD_RTOL * n, (k, err / n)
        else:
            assert err <= GRAD_NOISE * gnorm, (k, err, gnorm)


def test_batch_norm_running_stats_after_one_training_forward(loss_pair):
    want, got = loss_pair["jax_stats"], loss_pair["stats"]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert np.all(np.abs(got[k] - v) <= BN_TOL * (1 + np.abs(v))), k


def test_batch_norm_training_mode_is_flax_s():
    """One layer alone: Flax's BatchNorm(momentum 0.97, eps 1e-3, fast
    variance) in training mode, output and both running statistics."""
    import flax.linen as fnn

    from rtvm_tpu_torch.models.yolo.modules import BatchNorm

    x = np.random.RandomState(1).normal(3.0, 2.0, (4, 5, 6, 7)).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.97, epsilon=1e-3)
    rng = np.random.RandomState(2)
    variables = {"params": {"scale": rng.rand(7).astype(np.float32) + 0.5,
                            "bias": rng.rand(7).astype(np.float32)},
                 "batch_stats": {"mean": rng.rand(7).astype(np.float32),
                                 "var": rng.rand(7).astype(np.float32) + 0.5}}
    y, mut = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    m = BatchNorm(7).train()
    m.load_state_dict({k: _t(v) for c in variables.values() for k, v in c.items()})
    out = m(_nchw(x))
    np.testing.assert_allclose(np.moveaxis(out.detach().numpy(), 1, -1), np.asarray(y),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m.mean.numpy(), mut["batch_stats"]["mean"], rtol=BN_TOL)
    np.testing.assert_allclose(m.var.numpy(), mut["batch_stats"]["var"], rtol=BN_TOL)


def _trainer_tx(steps, lr=2e-3):
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, min(500, steps // 4), steps, lr * 0.05)
    jtx = optax.chain(optax.clip_by_global_norm(10.0), optax.adamw(sched, weight_decay=5e-4))
    ttx = TO.AdamW(TO.warmup_cosine_decay_schedule(0.0, lr, min(500, steps // 4), steps, lr * 0.05),
                   weight_decay=5e-4, clip_norm=10.0)
    return jtx, ttx


def _assert_moments_close(mine: "TC.NamedNode", theirs: "TC.NamedNode"):
    """Two ScaleByAdamState nodes: counts equal, mu and nu close."""
    assert int(mine.children[0]) == int(theirs.children[0])
    for m, t in zip(mine.children[1:], theirs.children[1:]):
        a, b = flatten_tree(m), flatten_tree(t)
        assert sorted(a) == sorted(b)
        d = np.concatenate([np.ravel(np.abs(a[k] - b[k]) / (1 + np.abs(b[k]))) for k in b])
        assert (d <= MOMENT_TOL).mean() >= PARAM_SHARE, (d <= MOMENT_TOL).mean()


def _assert_params_close(got: dict, want: dict, lr: float, steps: int, share=PARAM_SHARE):
    assert sorted(got) == sorted(want)
    g = np.concatenate([np.ravel(got[k]) for k in sorted(want)])
    w = np.concatenate([np.ravel(want[k]) for k in sorted(want)])
    close, worst = _close_share(g, w, PARAM_ATOL)
    assert close >= share and worst <= 2 * lr * steps, (close, worst)


def test_schedules_match_optax_at_every_count():
    steps, lr = 40, 2e-3
    jw = optax.warmup_cosine_decay_schedule(0.0, lr, min(500, steps // 4), steps, lr * 0.05)
    tw = TO.warmup_cosine_decay_schedule(0.0, lr, min(500, steps // 4), steps, lr * 0.05)
    jc, tc = optax.cosine_decay_schedule(1e-3, steps, 0.05), TO.cosine_decay_schedule(1e-3, steps, 0.05)
    assert tw(0) == 0.0  # update 0 of the warmup runs at lr 0
    for count in range(steps + 3):
        for j, t in ((jw, tw), (jc, tc)):
            want = float(j(jnp.int32(count)))
            assert abs(t(count) - want) <= SCHED_RTOL * max(abs(want), 1e-12), (count, t(count), want)
    # a run too short to warm up (JAX's 3-step runs): straight into the decay
    j3 = optax.warmup_cosine_decay_schedule(0.0, lr, 0, 3, lr * 0.05)
    t3 = TO.warmup_cosine_decay_schedule(0.0, lr, 0, 3, lr * 0.05)
    for count in range(4):
        assert abs(t3(count) - float(j3(count))) <= SCHED_RTOL * float(j3(count))


def test_clip_by_global_norm_is_optax_s():
    rng = np.random.RandomState(4)
    grads = [rng.normal(0, 3, s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    for scale in (0.1, 10.0):  # under and over the norm of 10
        g = [a * scale for a in grads]
        want, _ = optax.clip_by_global_norm(10.0).update([jnp.asarray(a) for a in g], None)
        got = [_t(a.copy()) for a in g]
        TO.clip_by_global_norm_(got, 10.0)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


@pytest.mark.parametrize("tree", [
    {"params": {"b": {"x": 1}, "a": 2}, "batch_stats": {}},
    {},
    {"params": {}},
    (1, (2,), {"k": 3}),
])
def test_treedef_string_is_jax_s(tree):
    jtree = jax.tree_util.tree_map(lambda v: np.zeros(v), tree)
    assert TC.treedef_str(tree) == str(jax.tree_util.tree_structure(jtree))


def test_train_state_round_trips_and_orbax_paths_raise(tmp_path):
    _, _, tm = _checkpoint("yolov8n")
    _, ttx = _trainer_tx(40)
    state = TT.TrainState(tm, ttx.init(tm.parameters()), step=7)
    tree = TT.state_tree(state)
    path = TC.save_train_state(str(tmp_path), tree, 7)
    assert path.endswith("step_7.npz")
    back = TC.load_train_state(path, like=tree)
    assert TC.treedef_str(back) == TC.treedef_str(tree)
    for a, b in zip(TC.tree_leaves(back), TC.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ImportError, match="orbax"):
        TC.load_train_state(str(tmp_path), like=tree)
    with pytest.raises(ValueError, match="structure mismatch"):
        TC.load_pytree_npz(path, like={"params": tree.children[0]})


EVAL_N = 16  # held-out scenes in the trainers' reports (48 in the trainers): one batch


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory, request):
    """JAX's train_synth.train and the port's (3 steps, batch 2, imgsz 64,
    EVAL_N scenes in the report), both starting from the same JAX weights
    (the bundled YOLOv8n in place of build_yolo's random init) and fed
    JAX's batches: their output directories, the JAX weights and JAX's
    jitted step (captured, so that the optimizer test reuses its
    compilation).

    Not from Flax's random init: there the first layers' training-mode
    BatchNorm cancels badly in float32 (E[x^2] - E[x]^2 of channels whose
    mean dwarfs their spread), and JAX's own loss is 3.2e-5 off a float64
    run of the same step where the port's is 6.9e-8 off; three Adam steps
    then leave 0.18 of the parameters within 1e-5 of each other (measured
    on these batches)."""
    mp = pytest.MonkeyPatch()
    request.addfinalizer(mp.undo)
    jdir, tdir = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    model, variables, _ = _checkpoint("yolov8n")
    mp.setattr(JM, "build_yolo", lambda *a, **k: (model, variables))
    jax_eval, port_eval = JTS.evaluate, TTS.evaluate
    mp.setattr(JTS, "evaluate", lambda m, v, n, size: jax_eval(m, v, n=EVAL_N, size=size))
    mp.setattr(TTS, "evaluate", lambda m, n, size: port_eval(m, n=EVAL_N, size=size))
    jitted = []
    real_jit = jax.jit

    def recording_jit(fn, *a, **k):
        out = real_jit(fn, *a, **k)
        if fn.__name__ == "step_fn":
            jitted.append(out)
        return out

    mp.setattr(jax, "jit", recording_jit)
    JTS.train("yolov8n", steps=3, batch=2, imgsz=64, out_dir=str(jdir), log_every=1)
    mp.setattr(jax, "jit", real_jit)
    port_build = TM.build_yolo

    def build_from_jax_init(*a, **k):
        m = port_build("yolov8n", num_classes=NC, device="cpu")
        m.load_state_dict(flax_to_state_dict(flatten_tree(variables), "yolov8n"))
        return m

    mp.setattr(TM, "build_yolo", build_from_jax_init)
    mp.setattr(TTS, "make_batch", JS.make_batch)
    mp.setattr(TTS, "BackgroundPool", JS.BackgroundPool)
    TTS.train("yolov8n", steps=3, batch=2, imgsz=64, out_dir=str(tdir), log_every=1, device="cpu")
    mp.setattr(TM, "build_yolo", port_build)
    return dict(jdir=jdir, tdir=tdir, variables=variables, step_fn=jitted[0])


def test_optimizer_steps_match_make_train_step(train_runs):
    """1 and 3 steps of the trainer's optimizer (clip 10, AdamW with the
    warmup-cosine schedule of a 3-step run, weight decay 5e-4) from the
    bundled YOLOv8n, on JAX's batches: parameters, statistics, moments.
    JAX's side is the trainer's own jitted step (make_train_step inside)."""
    lr, steps = 2e-3, 3
    _, variables, tm = _checkpoint("yolov8n")
    jtx, ttx = _trainer_tx(steps, lr)
    jstate = JT.TrainState(variables["params"], variables["batch_stats"],
                           jtx.init(variables["params"]), jnp.int32(0))
    tstate = TT.TrainState(tm, ttx.init(tm.parameters()))
    tstep = TT.make_train_step(tm, ttx)
    rng = np.random.RandomState(3)
    bg = JS.BackgroundPool(64, rng=rng)
    for i in range(steps):
        imgs, boxes, cls, valid = JS.make_batch(rng, bg, 2, 64)
        jstate, jmet = train_runs["step_fn"](jstate, *(jnp.asarray(a) for a in (imgs, boxes, cls, valid)))
        x = TTS._bgr_to_rgb01(_t(imgs))
        tstate, tmet = tstep(tstate, x, TT.Targets(_t(boxes), _t(cls), _t(valid)))
        assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= 1e-4 * abs(float(jmet["loss"]))
        if i in (0, steps - 1):
            want = flatten_tree({"params": _np_tree(jstate.params),
                                 "batch_stats": _np_tree(jstate.batch_stats)})
            got = flatten_tree(torch_to_flax(tm))
            _assert_params_close(got, want, lr, i + 1)
            adam = jstate.opt_state[1][0]
            tadam = TT.state_tree(tstate).children[2][1][0]
            _assert_moments_close(tadam, TC.NamedNode("ScaleByAdamState", (
                np.asarray(adam.count), _np_tree(adam.mu), _np_tree(adam.nu))))
            assert int(adam.count) == i + 1 == tstate.step


def _fresh_state():
    tm = TM.build_yolo("yolov8n", num_classes=NC, device="cpu")
    _, ttx = _trainer_tx(3)
    return TT.TrainState(tm, ttx.init(tm.parameters()))


def test_train_synth_writes_what_jax_writes(train_runs):
    jdir, tdir = train_runs["jdir"], train_runs["tdir"]
    names = ["yolov8n_aerial.npz", "yolov8n_aerial.json", "yolov8n_aerial_trainstate.npz"]
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == sorted(names)
    for name in names[::2]:
        with np.load(jdir / name) as a, np.load(tdir / name) as b:
            assert bytes(b["__treedef__"]) == bytes(a["__treedef__"])
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
    got, want = (TC.load_pytree_npz(str(d / names[0])) for d in (tdir, jdir))
    _assert_params_close({k: v for k, v in got.items() if k.startswith("params/")},
                         {k: v for k, v in want.items() if k.startswith("params/")}, 2e-3, 3,
                         E2E_SHARE)
    like = TT.state_tree(_fresh_state())
    mine, theirs = (TC.load_pytree_npz(str(d / names[2]), like=like) for d in (tdir, jdir))
    _assert_params_close(flatten_tree(mine.children[0]), flatten_tree(theirs.children[0]),
                         2e-3, 3, E2E_SHARE)
    got, want = flatten_tree(mine.children[1]), flatten_tree(theirs.children[1])
    worst = max(float(np.max(np.abs(got[k] - v) / (1 + np.abs(v)))) for k, v in want.items())
    assert sorted(got) == sorted(want) and worst <= STATS_TOL, worst
    _assert_moments_close(mine.children[2][1][0], theirs.children[2][1][0])
    assert int(mine.children[3]) == int(theirs.children[3]) == 3
    assert int(mine.children[2][1][2].children[0]) == int(theirs.children[2][1][2].children[0]) == 3
    ja, ta = (json.load(open(d / names[1])) for d in (jdir, tdir))
    assert {k: ta[k] for k in ("classes", "imgsz", "step")} == \
        {k: ja[k] for k in ("classes", "imgsz", "step")} == \
        {"classes": JS.AERIAL_CLASSES, "imgsz": 64, "step": 3}
    assert sorted(ta["eval"]) == sorted(ja["eval"])
    assert abs(ta["eval"]["mAP50"] - ja["eval"]["mAP50"]) <= MAP_TOL


def test_files_cross_between_the_packages(train_runs):
    """JAX's loader reads the port's files with JAX's own structure; the
    port's --resume reads JAX's trainstate and continues at its step."""
    jdir, tdir, variables = train_runs["jdir"], train_runs["tdir"], train_runs["variables"]
    restored = JC.load_pytree_npz(str(tdir / "yolov8n_aerial.npz"), variables)
    assert jax.tree_util.tree_structure(restored) == jax.tree_util.tree_structure(variables)
    jtx = _trainer_tx(3)[0]
    like = JT.TrainState(variables["params"], variables.get("batch_stats", {}),
                         jtx.init(variables["params"]), jnp.int32(0))
    jstate = JC.load_pytree_npz(str(tdir / "yolov8n_aerial_trainstate.npz"), like)
    assert int(jstate.step) == 3 and int(jstate.opt_state[1][0].count) == 3

    # the port resumes from JAX's trainstate: every leaf as JAX wrote it
    tm = TM.build_yolo("yolov8n", num_classes=NC, device="cpu")
    _, ttx = _trainer_tx(3)
    state = TT.TrainState(tm, ttx.init(tm.parameters()))
    TTS.resume_state(state, str(jdir / "yolov8n_aerial_trainstate.npz"))
    assert state.step == 3
    with np.load(jdir / "yolov8n_aerial_trainstate.npz") as f:
        for i, leaf in enumerate(TC.tree_leaves(TT.state_tree(state))):
            np.testing.assert_array_equal(leaf, f[f"leaf_{i}"])
    # and a resumed run at its last step writes nothing new
    TTS.train("yolov8n", steps=3, batch=2, imgsz=64, out_dir=str(tdir / "again"), device="cpu",
              resume=str(jdir / "yolov8n_aerial_trainstate.npz"))
    assert os.listdir(tdir / "again") == []
