"""The port's open-vocabulary trainer (rtvm_tpu_torch.models.yolo.train_world)
against the JAX package's, float32 on the CPU, from the bundled
``weights/yolov8n_world.npz``.

Tolerances, as in tests/test_torch_train.py: the loss through the prompt
adapter relative 1e-5 (measured 4.2e-6), its gradients relative L2 1e-3 a
leaf above 1e-6 of the global norm (measured 5.0e-5), the others within
1e-6 of the global norm, the BatchNorm statistics of that forward within
1e-5 (1 + |value|) (measured 8.0e-7); the per-step prompts identical;
after 3 trainer steps (batch 2, imgsz 64, the same weights and JAX's
batches in both) the files' structure byte-equal, the parameters within
1e-5 on at least 0.997 of the values (measured 0.99971), the BatchNorm
statistics within 1e-3 (1 + |value|) (measured 4.4e-5), the moments as in
the YOLO test, the reports' mAP within 0.05; ``evaluate`` with the unseen
prompts on 16 held-out scenes at 160 px (float32 in both): every class's
AP within 0.02 and the mAP within 0.01 (measured equal, mAP50 0.9884).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import (E2E_SHARE, GRAD_NOISE, GRAD_RTOL, LOSS_RTOL, MAP_TOL, STATS_TOL,
                              _assert_moments_close, _assert_params_close, _nchw, _np_tree, _t,
                              _targets, _trainer_tx)

from rtvm_tpu.models.yolo import synth as JS
from rtvm_tpu.models.yolo import train as JT
from rtvm_tpu.models.yolo import train_world as JW
from rtvm_tpu.models.yolo import world as JWM
from rtvm_tpu.utils import checkpoint as JC
from rtvm_tpu_torch.models.yolo import train as TT
from rtvm_tpu_torch.models.yolo import train_world as TW
from rtvm_tpu_torch.models.yolo import world as TWM
from rtvm_tpu_torch.models.yolo.convert import flatten_tree, flax_to_state_dict, torch_to_flax_arrays
from rtvm_tpu_torch.utils import checkpoint as TC

torch.set_num_threads(1)  # tier 1 runs several test workers at once

WORLD = "weights/yolov8n_world.npz"
EVAL_N = 16
EVAL_AP_TOL, EVAL_MAP_TOL = 0.02, 0.01
JAX_EVALUATE, PORT_EVALUATE = JW.evaluate, TW.evaluate  # the fixture below patches both


def _world():
    flat = TC.load_pytree_npz(WORLD)
    jm = JWM.YOLOWorld(JWM.YoloConfig(variant="yolov8n", num_classes=JWM.EMBED_DIM), dim=JWM.EMBED_DIM)
    tm = TWM.build_yolo_world("yolov8n", device="cpu")
    tm.load_state_dict(flax_to_state_dict(flat, "yolov8n"))
    return jm, TC.flat_to_nested(flat), tm


def test_synonyms_and_unseen_prompts_are_jax_s():
    assert TW.SYNONYMS == JW.SYNONYMS and TW.UNSEEN_PROMPTS == JW.UNSEEN_PROMPTS


def test_world_loss_and_gradients_match_jax():
    """yolo_loss through each package's prompt adapter, with prompts that
    are not the class names."""
    jm, jv, tm = _world()
    imgs = np.random.RandomState(7).rand(2, 64, 64, 3).astype(np.float32)
    boxes, cls, valid = _targets()
    prompts = [JW.SYNONYMS[c][-1] for c in JS.AERIAL_CLASSES]
    ids, mask = JWM.tokenize_names(prompts)

    @jax.jit
    def value_and_grad(params, batch_stats):
        adapter = JW._WorldAdapter(jm, jnp.asarray(ids), jnp.asarray(mask))

        def lf(p):
            return JT.yolo_loss(adapter, {"params": p, "batch_stats": batch_stats}, jnp.asarray(imgs),
                                JT.Targets(jnp.asarray(boxes), jnp.asarray(cls), jnp.asarray(valid)),
                                train=True)

        return jax.value_and_grad(lf, has_aux=True)(params)

    (jl, (mutated, _)), jg = value_and_grad(jv["params"], jv["batch_stats"])
    adapter = TW._WorldAdapter(tm, *TW._tokens(prompts, torch.device("cpu")))
    tl, _ = TT.yolo_loss(adapter, _nchw(imgs), TT.Targets(_t(boxes), _t(cls), _t(valid)))
    tl.backward()
    assert abs(float(tl) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    want = flatten_tree({"params": _np_tree(jg)})
    got = torch_to_flax_arrays({k: p.grad for k, p in tm.named_parameters()})
    assert sorted(got) == sorted(want)
    gnorm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in want.values()))
    for k, g in want.items():
        n, err = np.linalg.norm(g), np.linalg.norm(got[k] - g)
        assert err <= (GRAD_RTOL * n if n > GRAD_NOISE * gnorm else GRAD_NOISE * gnorm), k
    stats = torch_to_flax_arrays(dict(tm.named_buffers()))
    for k, v in flatten_tree({"batch_stats": _np_tree(mutated["batch_stats"])}).items():
        assert np.all(np.abs(stats[k] - v) <= 1e-5 * (1 + np.abs(v))), k


@pytest.fixture(scope="module")
def world_runs(tmp_path_factory, request):
    """JAX's train_world.train and the port's (3 steps, batch 2, imgsz 64,
    EVAL_N scenes in the report) from the bundled world weights, fed JAX's
    batches; the prompts each step tokenized, by package."""
    mp = pytest.MonkeyPatch()
    request.addfinalizer(mp.undo)
    jdir, tdir = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    jm, jv, _ = _world()
    prompts = {"jax": [], "port": []}
    jax_tok, port_tok = JWM.tokenize_names, TWM.tokenize_names

    def recorder(which, tok):
        def tokenize(names):
            prompts[which].append(list(names))
            return tok(names)
        return tokenize

    mp.setattr(JWM, "build_yolo_world", lambda *a, **k: (jm, jv))
    mp.setattr(JWM, "tokenize_names", recorder("jax", jax_tok))
    mp.setattr(JW, "evaluate", lambda m, v, imgsz: JAX_EVALUATE(m, v, n=EVAL_N, imgsz=imgsz))
    mp.setattr(TW, "evaluate", lambda m, imgsz: PORT_EVALUATE(m, n=EVAL_N, imgsz=imgsz))
    JW.train("yolov8n", steps=3, batch=2, imgsz=64, out_dir=str(jdir), log_every=1)

    port_build = TWM.build_yolo_world

    def build_from_jax(*a, **k):
        m = port_build("yolov8n", device="cpu")
        m.load_state_dict(flax_to_state_dict(flatten_tree(jv), "yolov8n"))
        return m

    mp.setattr(TWM, "build_yolo_world", build_from_jax)
    mp.setattr(TWM, "tokenize_names", recorder("port", port_tok))
    mp.setattr(TW, "make_batch", JS.make_batch)
    mp.setattr(TW, "BackgroundPool", JS.BackgroundPool)
    TW.train("yolov8n", steps=3, batch=2, imgsz=64, out_dir=str(tdir), log_every=1, device="cpu")
    return dict(jdir=jdir, tdir=tdir, prompts=prompts, jv=jv)


def test_prompts_are_sampled_as_jax_samples_them(world_runs):
    p = world_runs["prompts"]
    train_j = [x for x in p["jax"] if x != JS.AERIAL_CLASSES]
    train_t = [x for x in p["port"] if x != JS.AERIAL_CLASSES]
    assert len(train_j) == 3 and train_t == train_j
    assert any(x != JS.AERIAL_CLASSES for x in train_j)


def test_train_world_writes_what_jax_writes(world_runs):
    jdir, tdir = world_runs["jdir"], world_runs["tdir"]
    names = ["yolov8n_world.npz", "yolov8n_world.json", "yolov8n_world_trainstate.npz"]
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == sorted(names)
    for name in names[::2]:
        with np.load(jdir / name) as a, np.load(tdir / name) as b:
            assert bytes(b["__treedef__"]) == bytes(a["__treedef__"])
            for k in a.files:
                assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
    tm = TWM.build_yolo_world("yolov8n", device="cpu")
    _, ttx = _trainer_tx(3)
    like = TT.state_tree(TT.TrainState(tm, ttx.init(tm.parameters())))
    mine, theirs = (TC.load_pytree_npz(str(d / names[2]), like=like) for d in (tdir, jdir))
    _assert_params_close(flatten_tree(mine.children[0]), flatten_tree(theirs.children[0]),
                         2e-3, 3, E2E_SHARE)
    got, want = flatten_tree(mine.children[1]), flatten_tree(theirs.children[1])
    assert max(float(np.max(np.abs(got[k] - v) / (1 + np.abs(v)))) for k, v in want.items()) \
        <= STATS_TOL
    _assert_moments_close(mine.children[2][1][0], theirs.children[2][1][0])
    assert int(mine.children[3]) == int(theirs.children[3]) == 3
    ja, ta = (json.load(open(d / names[1])) for d in (jdir, tdir))
    assert {k: ta[k] for k in ("classes", "imgsz", "step")} == \
        {k: ja[k] for k in ("classes", "imgsz", "step")}
    assert abs(ta["eval"]["mAP50"] - ja["eval"]["mAP50"]) <= MAP_TOL
    # JAX reads the port's checkpoint with its own structure
    restored = JC.load_pytree_npz(str(tdir / names[0]), world_runs["jv"])
    assert jax.tree_util.tree_structure(restored) == jax.tree_util.tree_structure(world_runs["jv"])


def test_evaluate_with_unseen_prompts_matches_jax():
    jm, jv, tm = _world()
    prompts = [JW.UNSEEN_PROMPTS[c] for c in JS.AERIAL_CLASSES]
    want = JAX_EVALUATE(jm, jv, n=EVAL_N, imgsz=160, prompts=prompts)
    got = PORT_EVALUATE(tm, n=EVAL_N, imgsz=160, prompts=prompts)
    assert sorted(got) == sorted(want)
    assert want["mAP50"] > 0.3  # the unseen vocabulary still finds the classes
    assert abs(got["mAP50"] - want["mAP50"]) <= EVAL_MAP_TOL
    for k in want:
        assert abs(got[k] - want[k]) <= EVAL_AP_TOL, (k, got[k], want[k])
