"""The port's DepthNet (models/depthnet.py) and depth estimator
(depth3d/estimator.py) against the JAX package's, on the CPU, with the
repo's checkpoint weights/depthnet.npz."""

import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rtvm_tpu.models.depthnet as jdepthnet
from rtvm_tpu.depth3d import estimator as jestimator
from rtvm_tpu_torch.depth3d import estimator as testimator
from rtvm_tpu_torch.models import depthnet as tdepthnet
from rtvm_tpu_torch.utils.checkpoint import load_pytree_npz

torch.set_num_threads(1)  # tier 1 runs several test workers at once

CKPT = "weights/depthnet.npz"
NET_TOL = 1e-4  # DepthNet's sigmoid output, float32 on both sides
HEURISTIC_TOL = 1e-5


@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    """The JAX estimator probes huggingface.co before its own net; make the
    probe fail here, so it goes to its DepthNet without a connection."""
    def refuse(*a, **k):
        raise OSError("no network in the tests")

    monkeypatch.setattr(socket, "create_connection", refuse)


@pytest.fixture(scope="module")
def jest():
    """The JAX estimator, its hub route off: Flax DepthNet from CKPT."""
    return jestimator.MonocularDepthEstimator(prefer_hub=False)


@pytest.fixture(scope="module")
def nets(jest):
    return jest._flax, tdepthnet.build_depthnet(CKPT, device="cpu")


@pytest.mark.parametrize("h,w", [(48, 64), (45, 70), (61, 83)])
def test_depthnet_matches_flax_with_the_checkpoint(nets, h, w):
    """Even and odd sizes: SAME padding (0, 1) and (1, 1) at stride 2, and
    bilinear upsampling to odd sizes."""
    (model, variables), net = nets
    x = np.random.RandomState(h * w).rand(1, h, w, 3).astype(np.float32)
    want = np.asarray(model.apply(variables, jnp.asarray(x)))[0, ..., 0]
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2))[0, 0].numpy()
    assert got.shape == (h, w)
    np.testing.assert_allclose(got, want, rtol=0, atol=NET_TOL)


def test_same_padding_is_flax_s():
    assert tdepthnet.same_padding(90, 3, 2) == (0, 1)  # even: 90 -> 45
    assert tdepthnet.same_padding(45, 3, 2) == (1, 1)  # odd: 45 -> 23
    assert tdepthnet.same_padding(45, 3, 1) == (1, 1)
    net = tdepthnet.DepthNet()
    assert net._Block_0.GroupNorm_0.eps == 1e-6
    assert [getattr(net, f"_Block_{i}").stride for i in range(10)] == [1, 2, 2, 2, 2] + [1] * 5
    n_values = sum(a.size for a in load_pytree_npz(CKPT).values())
    assert sum(p.numel() for p in net.parameters()) == n_values  # about 3.4M


def test_checkpoint_conversion_covers_every_leaf_and_checks_names():
    tree = load_pytree_npz(CKPT)
    sd = tdepthnet.flax_to_state_dict(tree)
    assert set(sd) == set(tdepthnet.DepthNet().state_dict())
    np.testing.assert_array_equal(sd["_Block_1.Conv_0.weight"].numpy(),
                                  tree["params/_Block_1/Conv_0/kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["Dense_0.weight"].numpy(), tree["params/Dense_0/kernel"].T)
    np.testing.assert_array_equal(sd["_Block_9.GroupNorm_0.weight"].numpy(),
                                  tree["params/_Block_9/GroupNorm_0/scale"])
    broken = dict(tree)
    del broken["params/Dense_0/bias"]
    with pytest.raises(ValueError, match="missing"):
        tdepthnet.flax_to_state_dict(broken)
    broken = dict(tree, **{"params/Dense_0/bias": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="shapes"):
        tdepthnet.flax_to_state_dict(broken)


def test_random_weights_without_a_checkpoint_are_seeded():
    a, b = (tdepthnet.build_depthnet(seed=0, device="cpu") for _ in range(2))
    c = tdepthnet.build_depthnet(seed=1, device="cpu")
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    assert not torch.equal(a.Conv_0.weight, c.Conv_0.weight)


def _image(h=60, w=80, seed=0):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


def test_estimator_matches_jax(jest):
    img = _image()
    j = jest
    t = testimator.MonocularDepthEstimator(device="cpu")
    assert j.backend == "flax" and t.backend == "depthnet"
    assert t.checkpoint is not None and t.checkpoint.endswith("depthnet.npz")
    want, got = j.estimate_depth(img), t.estimate_depth(img)
    assert got.dtype == np.float32 and got.shape == (60, 80)
    assert got.min() == 0.0 and got.max() == 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=NET_TOL)
    # the hub route's argument does not change the route
    assert testimator.MonocularDepthEstimator(prefer_hub=False, device="cpu").backend == "depthnet"
    assert set(testimator.MODEL_REGISTRY) == set(jestimator.MODEL_REGISTRY)


def test_heuristic_only_when_the_net_cannot_be_built(monkeypatch):
    img = _image(seed=1)

    def boom(*a, **k):
        raise RuntimeError("no net today")

    monkeypatch.setattr(jdepthnet, "build_depthnet", boom)
    monkeypatch.setattr(tdepthnet, "build_depthnet", boom)
    j = jestimator.MonocularDepthEstimator(prefer_hub=False)
    t = testimator.MonocularDepthEstimator(device="cpu")
    assert j.backend == t.backend == "heuristic" and t.net is None
    np.testing.assert_allclose(t.estimate_depth(img), j.estimate_depth(img), rtol=0,
                               atol=HEURISTIC_TOL)


def test_estimate_time_errors_raise():
    """No fallback at estimate time: a net that fails while running raises."""
    t = testimator.MonocularDepthEstimator(device="cpu")

    def broken(x):
        raise RuntimeError("the device failed")

    t.net = broken
    with pytest.raises(RuntimeError, match="device failed"):
        t.estimate_depth(_image())


def test_moving_the_net_to_its_device_does_not_fall_back(monkeypatch):
    """The heuristic is for a net that cannot be built or loaded: an error
    while the built net moves onto its device (a CUDA error, out of memory)
    raises."""
    build = tdepthnet.build_depthnet

    def failing_move(*a, **k):
        net = build(*a, **k)

        def to(device):
            raise RuntimeError("CUDA out of memory")

        net.to = to
        return net

    monkeypatch.setattr(tdepthnet, "build_depthnet", failing_move)
    with pytest.raises(RuntimeError, match="out of memory"):
        testimator.MonocularDepthEstimator(device="cpu")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        testimator.MonocularDepthEstimator()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdepthnet.build_depthnet()


class _Capture:
    """cv2.VideoCapture over an array of frames, so that the JAX estimator
    reads the frames the port reads from a .npy file."""

    def __init__(self, frames):
        self.frames, self.i = frames, 0

    def read(self):
        if self.i >= len(self.frames):
            return False, None
        self.i += 1
        return True, self.frames[self.i - 1].copy()

    def release(self):
        pass


def test_estimate_depth_video_samples_as_jax(tmp_path, monkeypatch, jest):
    import cv2

    frames = np.stack([_image(36, 48, seed=s) for s in range(9)])
    np.save(tmp_path / "clip.npy", frames)
    monkeypatch.setattr(cv2, "VideoCapture", lambda path: _Capture(frames))
    j = jest
    t = testimator.MonocularDepthEstimator(device="cpu")
    want = list(j.estimate_depth_video("clip.avi", frame_step=3, max_frames=2))
    got = list(t.estimate_depth_video(str(tmp_path / "clip.npy"), frame_step=3, max_frames=2))
    assert len(got) == len(want) == 2
    for (gf, gd), (wf, wd) in zip(got, want):
        np.testing.assert_array_equal(gf, wf)
        np.testing.assert_allclose(gd, wd, rtol=0, atol=NET_TOL)
    assert np.array_equal(got[1][0], frames[3])
    assert len(list(t.estimate_depth_video(frames, frame_step=4, max_frames=10))) == 3
