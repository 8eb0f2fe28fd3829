"""The port's SuperPoint + SuperGlue against the JAX package's matcher (which
runs the two networks through ``transformers``), on the CPU, on the same
weights and seeded images.

- Preprocessing: the port's numpy emulation of ``SuperGlueImageProcessor``
  (PIL's bilinear resize included) bit-equal to the processor's
  ``pixel_values`` when it upscales (378x504), shrinks both axes (756x1008)
  and mixes (546x980), on a grey and on a float image.
- SuperPoint per image, and SuperGlue's log-assignment, matches and
  matching scores, on the tiny test architecture and once at the published
  one (13,324,162 parameters). Keypoints, masks and match indices must be
  equal; scores within 1e-6, descriptors within 1e-5, the log-assignment
  within 1e-5 relative (the same operations in the same order: in practice
  every value is equal).
- ``HFSuperGlueMatcher.match`` on the ``config=`` branch and on the
  ``pretrained=`` branch from a ``save_pretrained`` directory with
  ``model.safetensors`` and with ``pytorch_model.bin``; a saved detector
  config unlike the knobs, where the port applies the knobs and the JAX
  matcher does not; ``chip_smoke.py``'s hub-cache writer read back by
  ``transformers`` and the port; the port's safetensors reader on every
  dtype ``safetensors`` writes; the hub-cache
  resolver on a hand-built layout; ``matcher_from_config`` with and
  without weights; the thirdparty ``SuperGlueMatcher`` through a mock of
  ``models.matching``; ``build_match_cache`` and the driver's match cache
  against the JAX package's.

Random weights match almost nothing at the configured ``match_threshold``
0.2, so the comparisons run at 0.0 and on the raw outputs, and every pair
must keep at least one match. The shared weights are :func:`seeded`: the
detector's at a scale whose scores are not all equal, and the final
projection scaled by :data:`FINAL_SCALE` so that the matches are not all
near-uniform.
"""
import copy
import os
import sys
import types
import warnings

import numpy as np
import pytest

# Only transformers' torch models are used; without this it also imports
# TensorFlow, which takes most of its import time.
os.environ.setdefault("USE_TF", "0")
pytest.importorskip("jax")
transformers = pytest.importorskip("transformers")
import torch  # noqa: E402
from transformers import (  # noqa: E402
    SuperGlueConfig,
    SuperGlueForKeypointMatching,
    SuperGlueImageProcessor,
    SuperPointConfig,
    SuperPointForKeypointDetection,
)
from transformers.models.superglue import modeling_superglue as hf_glue  # noqa: E402

from _torch_support import hang_watchdog  # noqa: E402,F401
from _torch_support import smooth_texture, write_llff_scene  # noqa: E402
from scnerf_tpu.matching import provider as jprovider  # noqa: E402
from scnerf_tpu.matching import superglue_hf as jhf  # noqa: E402
from scnerf_tpu_torch import bridge  # noqa: E402
from scnerf_tpu_torch.core.config import CameraFlags  # noqa: E402
from scnerf_tpu_torch.matching import provider as tprovider  # noqa: E402
from scnerf_tpu_torch.matching import superglue_hf as thf  # noqa: E402
from scnerf_tpu_torch.matching.superglue import SuperGlue  # noqa: E402
from scnerf_tpu_torch.matching.superpoint import SuperPoint  # noqa: E402

SCORE_ATOL = 1e-6
DESCRIPTOR_ATOL = 1e-5
ASSIGNMENT_RTOL = 1e-5
FINAL_SCALE = 30.0
PUBLISHED = {  # the magic-leap architecture at CameraFlags' thresholds
    "keypoint_detector_config": {"model_type": "superpoint", "max_keypoints": 1024,
                                 "keypoint_threshold": 0.005, "nms_radius": 4},
    "hidden_size": 256, "keypoint_encoder_sizes": [32, 64, 128, 256],
    "gnn_layers_types": ["self", "cross"] * 9, "num_attention_heads": 4,
    "sinkhorn_iterations": 20,
}
FLAGS_KNOBS = {"max_keypoints": 1024, "keypoint_threshold": 0.005, "nms_radius": 4}


def textured(seed, h, w):
    """A seeded ``(h, w, 3)`` float image in [0, 1]: smooth waves plus
    pixel noise, so SuperPoint finds keypoints everywhere."""
    rng = np.random.RandomState(seed)
    return np.clip(smooth_texture(rng, h, w) + 0.15 * rng.randn(h, w, 3), 0.0, 1.0)


def pair(seed, h=96, w=128, shift=4):
    base = textured(seed, h, w)
    return base, np.roll(base, shift, axis=1)


def seeded(model, seed: int, scale: float = FINAL_SCALE):
    """``model``'s weights from ``seed``: ``transformers``' initialisation,
    but the detector's convolutions at He's fan-in scale (at 0.02 the
    activations of eight convolutions vanish, every score is 1/65 and the
    keypoints are a tie-break), and the final projection times ``scale``.
    The same function of a ``transformers`` model and of the port's."""
    gen = torch.Generator().manual_seed(seed)
    if hasattr(model, "bin_score"):
        thf.init_weights(model, gen)
        detector = model.keypoint_detector
    else:
        detector = model
    with torch.no_grad():
        for m in detector.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.normal_(0.0, (2.0 / m.weight[0].numel()) ** 0.5, generator=gen)
                m.bias.zero_()
        if hasattr(model, "bin_score"):
            model.final_projection.final_proj.weight.mul_(scale)
    return model


def hf_superglue(config: dict, seed: int = 0, scale: float = FINAL_SCALE):
    """The ``transformers`` model of a config dict, :func:`seeded`; and its
    state as numpy."""
    model = SuperGlueForKeypointMatching(SuperGlueConfig(**copy.deepcopy(config))).eval()
    seeded(model, seed, scale)
    return model, {k: v.numpy() for k, v in model.state_dict().items()}


def port_superglue(config: dict, state: dict) -> SuperGlue:
    model = SuperGlue(copy.deepcopy(config))
    model.load_state_dict(bridge.superglue_state_from_numpy(state, "cpu"), strict=True)
    return model.eval()


def tiny(**detector):
    cfg = thf.tiny_superglue_config()
    cfg["keypoint_detector_config"].update(detector)
    return cfg


def pixel_values(processor, img0, img1):
    return processor([[thf.to_u8(img0), thf.to_u8(img1)]], return_tensors="pt")["pixel_values"]


def run_both(hf_model, port_model, pixels, monkeypatch):
    """Both models on the processor's pixels: (HF outputs with its
    log-assignment, the port's outputs)."""
    seen = {}
    lot = hf_glue.log_optimal_transport

    def recording(*args, **kwargs):
        seen["z"] = lot(*args, **kwargs)
        return seen["z"]

    monkeypatch.setattr(hf_glue, "log_optimal_transport", recording)
    with torch.no_grad():
        return hf_model(pixel_values=pixels), seen.get("z"), port_model(pixels[:, :, :1])


def assert_outputs_alike(hf_out, hf_z, got):
    np.testing.assert_array_equal(got["keypoints"].numpy(), hf_out.keypoints.numpy())
    np.testing.assert_array_equal(got["mask"].numpy(), hf_out.mask.numpy())
    np.testing.assert_array_equal(got["matches"].numpy(), hf_out.matches.numpy())
    np.testing.assert_allclose(got["matching_scores"].numpy(), hf_out.matching_scores.numpy(),
                               rtol=0, atol=SCORE_ATOL)
    np.testing.assert_allclose(got["log_assignment"].numpy(), hf_z.numpy(),
                               rtol=ASSIGNMENT_RTOL, atol=0)
    assert int((got["matches"][0, 0] > -1).sum()) >= 1, "no match at threshold 0"


def assert_matches_equal(got, want):
    assert isinstance(got, tprovider.PairMatches)
    for a, b in ((got.kps0, want.kps0), (got.kps1, want.kps1)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got.confidence, want.confidence, rtol=0, atol=SCORE_ATOL)
    assert got.confidence.dtype == np.float32 and got.kps0.shape[0] >= 1


class TestPreprocessing:
    @pytest.mark.parametrize("shape", [(378, 504), (756, 1008), (546, 980), (480, 640),
                                       (37, 1001)])
    def test_pil_resize_bit_equal(self, shape):
        from PIL import Image

        img = (np.random.RandomState(shape[0]).rand(*shape, 3) * 256).astype(np.uint8)
        want = np.asarray(Image.fromarray(img).resize((640, 480), resample=Image.BILINEAR))
        np.testing.assert_array_equal(thf.pil_resize(img, 480, 640), want)

    @pytest.mark.parametrize("case", ["378x504", "756x1008", "546x980", "grey", "float",
                                      "uint8"])
    def test_processor_bit_equal(self, case):
        h, w = {"756x1008": (756, 1008), "546x980": (546, 980)}.get(case, (378, 504))
        img0, img1 = textured(1, h, w), textured(2, h, w)
        if case == "grey":  # a 2-D image, and one whose channels are equal
            img0, img1 = img0[..., 0], np.repeat(img1[..., :1], 3, axis=-1)
        if case == "float":  # out of [0, 1] and off the 1/255 grid
            img0, img1 = img0 * 1.3 - 0.1, (img1 * 0.9).astype(np.float32)
        if case == "uint8":
            img0, img1 = thf.to_u8(img0), thf.to_u8(img1)
        want = pixel_values(SuperGlueImageProcessor(), img0, img1)[0, :, 0].numpy()
        got = np.stack([thf.preprocess(thf.to_u8(img)) for img in (img0, img1)])
        assert got.dtype == want.dtype == np.float32 and got.shape == (2, 480, 640)
        np.testing.assert_array_equal(got, want)

    def test_processor_settings(self):
        img0, img1 = textured(3, 60, 90), textured(4, 60, 90)
        settings = {"size": {"height": 50, "width": 70}, "do_grayscale": False}
        want = pixel_values(SuperGlueImageProcessor(**settings), img0, img1)[0, :, 0].numpy()
        got = np.stack([thf.preprocess(thf.to_u8(img), settings) for img in (img0, img1)])
        np.testing.assert_array_equal(got, want)
        with pytest.raises(NotImplementedError):
            thf.preprocess(thf.to_u8(img0), {"resample": 3})


class TestSuperPoint:
    @pytest.mark.parametrize("knobs", [
        {},  # tiny: threshold 0, top 64
        {"max_keypoints": -1, "keypoint_threshold": 0.019, "nms_radius": 2},
        {"max_keypoints": 200, "border_removal_distance": 9, "nms_radius": 0},
    ])
    def test_per_image(self, knobs):
        cfg = {**thf.tiny_superglue_config()["keypoint_detector_config"], **knobs}
        hf = seeded(SuperPointForKeypointDetection(SuperPointConfig(**cfg)).eval(), 1)
        port = SuperPoint(cfg).eval()
        port.load_state_dict(hf.state_dict(), strict=True)
        pixels = pixel_values(SuperGlueImageProcessor(), *pair(5))[0]
        with torch.no_grad():
            want = hf(pixels)
            got = port(pixels[:, :1])
        n = want.mask.sum(1)
        assert n.min() > 0 and (cfg["max_keypoints"] < 0 or n.max() <= cfg["max_keypoints"])
        np.testing.assert_array_equal(got[0].numpy(), want.keypoints.numpy())
        np.testing.assert_array_equal(got[3].numpy(), want.mask.numpy())
        np.testing.assert_allclose(got[1].numpy(), want.scores.numpy(), rtol=0, atol=SCORE_ATOL)
        np.testing.assert_allclose(got[2].numpy(), want.descriptors.numpy(), rtol=0,
                                   atol=DESCRIPTOR_ATOL)


class TestSuperGlue:
    @pytest.mark.parametrize("case", ["top64", "all, padded"])
    def test_tiny(self, case, monkeypatch):
        if case == "top64":
            config, processor = tiny(), SuperGlueImageProcessor()
        else:  # every keypoint: the two images differ in count
            config = tiny(max_keypoints=-1)
            processor = SuperGlueImageProcessor(size={"height": 96, "width": 128})
        hf, state = hf_superglue(config)
        pixels = pixel_values(processor, *pair(6))
        out, z, got = run_both(hf, port_superglue(config, state), pixels, monkeypatch)
        counts = out.mask.sum(-1)[0].tolist()
        assert (counts[0] != counts[1]) == (case != "top64"), counts
        assert_outputs_alike(out, z, got)

    def test_published_architecture(self, monkeypatch):
        hf, state = hf_superglue(PUBLISHED, seed=2, scale=1.0)
        assert sum(p.numel() for p in hf.parameters()) == 13_324_162
        port = port_superglue(PUBLISHED, state)
        img0, img1 = pair(7, 378, 504, shift=8)
        out, z, got = run_both(hf, port, pixel_values(SuperGlueImageProcessor(), img0, img1),
                               monkeypatch)
        assert out.mask.sum(-1).tolist() == [[1024, 1024]]
        assert_outputs_alike(out, z, got)

    def test_config_checks(self):
        for key in ("keypoint_encoder_sizes", "gnn_layers_types"):
            cfg = tiny()
            del cfg[key]
            with pytest.raises(ValueError, match=key):
                SuperGlue(cfg)
        with pytest.raises(ValueError, match="self"):
            SuperGlue(dict(tiny(), gnn_layers_types=["self", "other"]))

    def test_no_keypoints(self):
        model = SuperGlue(tiny(keypoint_threshold=2.0)).eval()  # scores lie below 1
        with torch.no_grad():
            out = model(torch.rand(1, 2, 1, 64, 64))
        assert out["keypoints"].shape == (1, 2, 0, 2) and out["log_assignment"] is None
        assert out["matches"].shape == (1, 2, 0) and out["matches"].dtype == torch.int32


def test_tiny_config_is_the_jax_one():
    want = jhf.tiny_superglue_config().to_dict()
    got = thf.tiny_superglue_config()
    for key, value in got.items():
        if key == "keypoint_detector_config":
            assert {k: want[key][k] for k in value} == value
        else:
            assert want[key] == value, key


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A ``save_pretrained`` directory of the tiny model at CameraFlags'
    detector thresholds and a 120x160 processor, in both weight formats."""
    config = tiny(**FLAGS_KNOBS)
    hf, state = hf_superglue(config, seed=3)
    processor = SuperGlueImageProcessor(size={"height": 120, "width": 160})
    dirs = {}
    for fmt, safe in (("safetensors", True), ("bin", False)):
        d = str(tmp_path_factory.mktemp(fmt))
        hf.save_pretrained(d, safe_serialization=safe)
        processor.save_pretrained(d)
        dirs[fmt] = d
    assert os.path.isfile(os.path.join(dirs["bin"], "pytorch_model.bin"))
    return {"config": config, "state": state, "dirs": dirs}


class TestMatcher:
    def test_config_branch(self):
        j = jhf.HFSuperGlueMatcher(config=SuperGlueConfig(**tiny()), match_threshold=0.0)
        seeded(j._model, 4)
        t = thf.HFSuperGlueMatcher(config=tiny(), match_threshold=0.0, device="cpu")
        assert t.device == torch.device("cpu") and not t.model.training
        t.model.load_state_dict(bridge.superglue_state_from_numpy(
            {k: v.numpy() for k, v in j._model.state_dict().items()}, "cpu"))
        for img0, img1 in (pair(8), pair(9, 120, 90, shift=-3)):
            assert_matches_equal(t.match(img0, img1), j.match(img0, img1))

    @pytest.mark.parametrize("fmt", ["safetensors", "bin"])
    def test_pretrained_branch(self, saved, fmt):
        d = saved["dirs"][fmt]
        knobs = dict(FLAGS_KNOBS, sinkhorn_iterations=7, match_threshold=0.0)
        j = jhf.HFSuperGlueMatcher(pretrained=d, **knobs)
        t = thf.HFSuperGlueMatcher(pretrained=d, device="cpu", **knobs)
        assert t.processor["size"] == {"height": 120, "width": 160}
        assert t.model.config["sinkhorn_iterations"] == 7
        for name, value in j._model.state_dict().items():
            assert torch.equal(t.model.state_dict()[name], value), name
        img0, img1 = pair(10, 100, 140)
        assert_matches_equal(t.match(img0, img1), j.match(img0, img1))

    def test_runtime_knobs_reach_the_detector(self, saved):
        """On the ``pretrained`` branch the knobs go onto the loaded config,
        and the port's detector reads them on each call."""
        t = thf.HFSuperGlueMatcher(pretrained=saved["dirs"]["safetensors"], max_keypoints=5,
                                   keypoint_threshold=0.0, match_threshold=0.0, device="cpu")
        out = t.run(t.prepare(*pair(11)))
        assert out["mask"].sum(-1).tolist() == [[5, 5]]

    def test_port_writer_read_by_transformers(self, saved, tmp_path):
        """``chip_smoke.py``'s hub-cache writer (phase 21's weights): its
        snapshot is read by ``transformers`` and by the port's loader, and
        resolved from the hub cache."""
        import chip_smoke

        state = bridge.superglue_state_from_numpy(saved["state"], "cpu")
        d = chip_smoke.write_hub_weights(str(tmp_path), "org/sg", saved["config"], state)
        hf = SuperGlueForKeypointMatching.from_pretrained(d, local_files_only=True)
        for name, value in state.items():
            assert torch.equal(hf.state_dict()[name], value), name
        proc = SuperGlueImageProcessor.from_pretrained(d, local_files_only=True)
        assert proc.size == {"height": 480, "width": 640} and proc.resample == 2
        config, processor, loaded = thf.load_pretrained(d)
        assert config["hidden_size"] == 64 and processor == thf.PROCESSOR_DEFAULTS
        assert all(torch.equal(loaded[k], v) for k, v in state.items())
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("HF_HUB_CACHE", str(tmp_path))
            assert thf.resolve_pretrained("org/sg") == d

    def test_safetensors_both_ways(self, saved, tmp_path):
        """The port's reader on ``transformers``' file and on every dtype
        that ``safetensors``' own writer writes."""
        from safetensors.torch import load_file, save_file

        path = os.path.join(saved["dirs"]["safetensors"], "model.safetensors")
        want = load_file(path)
        got = thf.read_safetensors(path)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
        tensors = {"f32": torch.randn(3, 4), "scalar": torch.tensor(1.5),
                   "i64": torch.arange(5), "bf16": torch.randn(2, 3).to(torch.bfloat16),
                   "f16": torch.randn(7).half(), "bool": torch.tensor([True, False]),
                   "u8": torch.arange(9, dtype=torch.uint8).reshape(3, 3),
                   "empty": torch.zeros(0, 2)}
        save_file(tensors, str(tmp_path / "x.safetensors"))
        back = thf.read_safetensors(str(tmp_path / "x.safetensors"))
        assert set(back) == set(tensors)
        for k, v in tensors.items():
            assert back[k].dtype == v.dtype and torch.equal(back[k], v), k

    def test_saved_detector_config_departs_from_jax(self, tmp_path):
        """A saved detector config whose values differ from the knobs: the
        port's detector takes the knobs, the JAX matcher's keeps the saved
        values (``transformers`` copies them when it builds the model), so
        the two caches agree only where ``config.json`` holds CameraFlags'
        values."""
        hf, _ = hf_superglue(tiny(max_keypoints=-1, keypoint_threshold=0.0), seed=3)
        hf.save_pretrained(str(tmp_path), safe_serialization=True)
        SuperGlueImageProcessor(size={"height": 120, "width": 160}).save_pretrained(str(tmp_path))
        knobs = dict(max_keypoints=5, keypoint_threshold=0.0, nms_radius=4, match_threshold=0.0)
        t = thf.HFSuperGlueMatcher(pretrained=str(tmp_path), device="cpu", **knobs)
        j = jhf.HFSuperGlueMatcher(pretrained=str(tmp_path), **knobs)
        img0, img1 = pair(12, 100, 140)
        got = t.run(t.prepare(img0, img1))["mask"].sum(-1).tolist()
        with torch.no_grad():
            want = j._model(pixel_values=pixel_values(j._processor, img0, img1))["mask"]
        want = want.sum(-1).tolist()
        assert got == [[5, 5]] and min(want[0]) > 5, (got, want)


def hub_layout(cache, repo_id, source, commit="0123abcd"):
    """``source``'s files as the hub cache holds ``repo_id`` at ``commit``."""
    repo = os.path.join(cache, "models--" + repo_id.replace("/", "--"))
    snapshot = os.path.join(repo, "snapshots", commit)
    os.makedirs(snapshot)
    os.makedirs(os.path.join(repo, "refs"))
    with open(os.path.join(repo, "refs", "main"), "w") as f:
        f.write(commit)
    for name in os.listdir(source):
        with open(os.path.join(source, name), "rb") as a, \
                open(os.path.join(snapshot, name), "wb") as b:
            b.write(a.read())
    return snapshot


class TestWeightsResolution:
    def test_hub_cache(self, saved, tmp_path, monkeypatch):
        from huggingface_hub import try_to_load_from_cache

        repo_id = thf.HUB_IDS["indoor"]
        cache = str(tmp_path / "hub")
        snapshot = hub_layout(cache, repo_id, saved["dirs"]["safetensors"])
        for env in ({"HF_HUB_CACHE": cache}, {"HF_HOME": str(tmp_path)},
                    {"HOME": str(tmp_path / "home")}):
            for name in ("HF_HUB_CACHE", "HF_HOME"):
                monkeypatch.delenv(name, raising=False)
            for name, value in env.items():
                monkeypatch.setenv(name, value)
            if "HOME" in env:
                os.makedirs(tmp_path / "home" / ".cache" / "huggingface")
                os.symlink(cache, tmp_path / "home" / ".cache" / "huggingface" / "hub")
            assert thf.hub_cache_dir() == os.path.join(*{
                "HF_HUB_CACHE": [cache], "HF_HOME": [str(tmp_path), "hub"],
                "HOME": [str(tmp_path / "home"), ".cache", "huggingface", "hub"]}[
                next(iter(env))])
            got = thf.resolve_pretrained(repo_id)
            want = try_to_load_from_cache(repo_id, "config.json", cache_dir=thf.hub_cache_dir())
            assert got is not None and os.path.samefile(got, snapshot)
            assert os.path.samefile(got, os.path.dirname(want))
            assert thf.hf_superglue_available("indoor")
            assert not thf.hf_superglue_available("outdoor")

    def test_incomplete_layouts(self, saved, tmp_path, monkeypatch):
        cache = str(tmp_path / "hub")
        monkeypatch.setenv("HF_HUB_CACHE", cache)
        snapshot = hub_layout(cache, "org/name", saved["dirs"]["bin"])
        assert thf.resolve_pretrained("org/name") == snapshot
        os.remove(os.path.join(snapshot, "pytorch_model.bin"))
        assert thf.resolve_pretrained("org/name") is None  # no weights
        os.remove(os.path.join(cache, "models--org--name", "refs", "main"))
        assert thf.resolve_pretrained("org/name") is None  # no refs/main
        assert thf.resolve_pretrained(saved["dirs"]["bin"]) == saved["dirs"]["bin"]
        assert thf.resolve_pretrained(str(tmp_path)) is None  # a directory without them
        assert not thf.hf_superglue_available(pretrained=str(tmp_path))
        with pytest.raises(FileNotFoundError):
            thf.HFSuperGlueMatcher(pretrained=str(tmp_path), device="cpu")


@pytest.fixture
def jax_cache(monkeypatch):
    """Point the JAX package's ``transformers`` and the port at one hub
    cache directory; returns a function that sets it."""
    import transformers.utils.hub as hf_hub

    def point(cache):
        monkeypatch.setenv("HF_HUB_CACHE", cache)
        monkeypatch.setattr(hf_hub, "TRANSFORMERS_CACHE", cache)

    return point


class TestMatcherFromConfig:
    def test_without_weights_warns(self, tmp_path, jax_cache):
        jax_cache(str(tmp_path))
        for name in ("models", "models.matching"):
            sys.modules.pop(name, None)
        for module, flags in ((tprovider, CameraFlags), (jprovider, _jax_flags())):
            with pytest.warns(UserWarning, match="superglue"):
                assert module.matcher_from_config(flags(matcher="superglue")) is None

    @pytest.mark.parametrize("weight", ["outdoor", "indoor"])
    def test_with_weights_in_the_hub_cache(self, saved, tmp_path, jax_cache, weight):
        cache = str(tmp_path / "hub")
        hub_layout(cache, thf.HUB_IDS[weight], saved["dirs"]["safetensors"])
        jax_cache(cache)
        flags = dict(matcher="superglue", superglue_weight=weight, match_threshold=0.0,
                     sinkhorn_iterations=9)
        t = tprovider.matcher_from_config(CameraFlags(**flags), device="cpu")
        j = jprovider.matcher_from_config(_jax_flags()(**flags))
        assert isinstance(t, thf.HFSuperGlueMatcher) and isinstance(j, jhf.HFSuperGlueMatcher)
        assert t.device == torch.device("cpu") and t.model.config["sinkhorn_iterations"] == 9
        assert t.model.keypoint_detector.config["max_keypoints"] == 1024
        img0, img1 = pair(12, 90, 130)
        assert_matches_equal(t.match(img0, img1), j.match(img0, img1))


def _jax_flags():
    from scnerf_tpu.core.config import CameraFlags as JaxFlags

    return JaxFlags


class TestThirdPartyMatcher:
    """The reference's ``models.matching`` package is not in the repository;
    a mock holds the matcher's plumbing, as ``tests/test_matching.py`` does
    for the JAX package."""

    def _install_mock(self, monkeypatch, kps0, kps1, matches, scores):
        captured = {}

        class MockMatching:
            def __init__(self, config):
                captured["config"] = config

            def eval(self):
                return self

            def to(self, device):
                captured["device"] = device
                return self

            def __call__(self, inputs):
                captured["inputs"] = inputs
                captured["tf32"] = (torch.backends.cuda.matmul.allow_tf32,
                                    torch.backends.cudnn.allow_tf32)
                return {
                    "keypoints0": [torch.from_numpy(kps0)],
                    "keypoints1": [torch.from_numpy(kps1)],
                    "matches0": [torch.from_numpy(matches)],
                    "matching_scores0": [torch.from_numpy(scores)],
                }

        mod = types.ModuleType("models.matching")
        mod.Matching = MockMatching
        pkg = types.ModuleType("models")
        pkg.matching = mod
        monkeypatch.setitem(sys.modules, "models", pkg)
        monkeypatch.setitem(sys.modules, "models.matching", mod)
        return captured

    def test_plumbing_and_match_selection(self, monkeypatch):
        kps0 = np.array([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]], np.float32)
        kps1 = np.array([[10.0, 20.0], [30.0, 40.0]], np.float32)
        matches = np.array([1, -1, 0])
        scores = np.array([0.9, 0.0, 0.7], np.float32)
        img = np.random.RandomState(1).rand(32, 48, 3).astype(np.float32)
        results = []
        for module, kwargs in ((tprovider, {"device": "cpu"}), (jprovider, {})):
            captured = self._install_mock(monkeypatch, kps0, kps1, matches, scores)
            matcher = module.SuperGlueMatcher(weights="outdoor", max_keypoints=77, **kwargs)
            assert captured["config"]["superpoint"]["max_keypoints"] == 77
            assert captured["config"]["superglue"]["weights"] == "outdoor"
            assert captured["device"] == "cpu"
            results.append(matcher.match(img, img[::-1].copy()))
            assert tuple(captured["inputs"]["image0"].shape) == (1, 1, 32, 48)
            np.testing.assert_array_equal(captured["inputs"]["image1"][0, 0].numpy(),
                                          tprovider.rgb_to_gray(img[::-1].copy()))
        assert captured["tf32"] == (torch.backends.cuda.matmul.allow_tf32,
                                    torch.backends.cudnn.allow_tf32)
        got, want = results
        np.testing.assert_array_equal(got.kps0, kps0[[0, 2]])
        np.testing.assert_array_equal(got.kps1, kps1[[1, 0]])
        for a, b in ((got.kps0, want.kps0), (got.kps1, want.kps1),
                     (got.confidence, want.confidence)):
            np.testing.assert_array_equal(a, b)

    def test_selected_without_hf_weights(self, monkeypatch, tmp_path):
        monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path))
        z = np.zeros((0, 2), np.float32)
        captured = self._install_mock(monkeypatch, z, z, np.zeros(0, np.int64),
                                      np.zeros(0, np.float32))
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            m = tprovider.matcher_from_config(CameraFlags(matcher="superglue"), device="cpu")
        assert isinstance(m, tprovider.SuperGlueMatcher) and captured["device"] == "cpu"

    def test_import_error_without_package(self):
        for name in ("models", "models.matching"):
            sys.modules.pop(name, None)
        with pytest.raises(ImportError):
            tprovider.SuperGlueMatcher(device="cpu")


def test_build_match_cache_alike(saved, tmp_path):
    d = saved["dirs"]["safetensors"]
    images = np.stack([textured(20 + i, 80, 110) for i in range(4)]).astype(np.float32)
    pairs = np.array([[0, 1], [1, 2], [0, 3]])
    knobs = dict(FLAGS_KNOBS, match_threshold=0.0)
    t = tprovider.build_match_cache(images, pairs, thf.HFSuperGlueMatcher(
        pretrained=d, device="cpu", **knobs), str(tmp_path / "t.npz"))
    j = jprovider.build_match_cache(images, pairs, jhf.HFSuperGlueMatcher(pretrained=d, **knobs),
                                    str(tmp_path / "j.npz"))
    assert t.pairs() == j.pairs() == [(0, 1), (0, 3), (1, 2)]
    for i, k in t.pairs():
        assert_matches_equal(t.get(i, k), j.get(i, k))
    tz, jz = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    assert sorted(tz.files) == sorted(jz.files)
    for name in jz.files:
        np.testing.assert_allclose(tz[name], jz[name], rtol=0, atol=SCORE_ATOL)


def test_driver_builds_its_cache_with_superglue(saved, tmp_path, jax_cache):
    """The training driver of each package, with ``matcher superglue`` and
    the weights in the hub cache, builds ``matches.npz`` itself over the
    pairs it selects; the port's cache equals the JAX package's, and the
    PRD sampler draws from it."""
    from scnerf_tpu.core.config import load_experiment as j_load
    from scnerf_tpu.train import driver as jdriver

    from scnerf_tpu_torch.core.config import load_experiment as t_load
    from scnerf_tpu_torch.train import driver as tdriver

    cache = str(tmp_path / "hub")
    hub_layout(cache, thf.HUB_IDS["outdoor"], saved["dirs"]["safetensors"])
    jax_cache(cache)
    scene = write_llff_scene(tmp_path / "scene", n_views=6, seed=9)
    fern = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", "llff", "fern_ours.txt")
    flags = {"datadir": scene, "netdepth": 2, "netwidth": 16, "multires": 2,
             "multires_views": 2, "N_samples": 4, "N_importance": 4, "N_rand": 64,
             "llffhold": 4, "match_num": 32, "add_ie": 0, "add_od": 0, "add_prd": 0,
             "matcher": "superglue", "match_threshold": 0.0}
    quiet = lambda *_: None  # noqa: E731
    os.makedirs(tmp_path / "t")
    os.makedirs(tmp_path / "j")
    t = tdriver.build_experiment(t_load(fern, flags, warn=quiet), str(tmp_path / "t"),
                                 device="cpu")
    j = jdriver.build_experiment(j_load(fern, flags, warn=quiet), str(tmp_path / "j"))
    assert len(t.pair_list) >= 1
    np.testing.assert_array_equal(t.pair_list, j.pair_list)
    tz, jz = np.load(tmp_path / "t" / "matches.npz"), np.load(tmp_path / "j" / "matches.npz")
    assert sorted(tz.files) == sorted(jz.files) and len(tz.files) == 3 * len(t.pair_list)
    for name in jz.files:
        np.testing.assert_allclose(tz[name], jz[name], rtol=0, atol=SCORE_ATOL)
    assert max(tz[n].shape[0] for n in tz.files if n.startswith("kps0")) >= 1
    assert tdriver.sample_prd_batch(t) is not None
    t.logger.close()
    j.logger.close()
