"""The port's serving export (``serve.export_serving_fn`` /
``load_serving_fn``, ``cli/export.py``) and K1's and K2's operators under
``torch.export``, on the CPU:

- the fake implementations of ``scnerf_tpu_torch::sample_pdf`` and
  ``::sample_pdf_fwd`` on ``meta`` tensors, both ``with_cdf``; a module
  calling the operators exports with them in its graph, and the loader lists
  them without building the CUDA library for a CPU artifact;
- the loaded artifact against the serve function it was exported from, bit
  for bit, for NeRF with and without NDC and for NeRF++ (on the CPU the
  kernels' wrappers take their plain twins, so the graph holds no operator);
- the loaded artifact against the JAX package's loaded ``jax.export``
  artifact of the same bridged weights, at the serving limits of
  ``tests/test_torch_render_serve.py:assert_det_maps_close``;
- no random operator in the exported graph, and a refusal of one that has;
- the loader's call in float32 with the caller's TF32 flags restored after;
- ``RenderService`` over a loaded artifact at a ragged request size, equal
  to the service over the serve function;
- the CLI: checkpoint -> artifact -> load -> call on a blender, an LLFF
  (NDC with the learned focal) and a NeRF++ scene, equal to the serve
  function of the restored experiment, and the sibling ``.json`` with the
  JAX CLI's keys plus ``device`` and ``operator_library`` (as
  ``tests/test_serve.py:211``).
"""
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_support import hang_watchdog  # noqa: E402,F401
from _torch_support import write_blender_scene, write_llff_scene, write_nerfpp_scene  # noqa: E402
from test_torch_render_serve import assert_det_maps_close  # noqa: E402
from scnerf_tpu import serve as jserve  # noqa: E402
from scnerf_tpu.fields import nerfpp as jfield_pp  # noqa: E402
from scnerf_tpu.fields.nerf import NeRFConfig as JNeRFConfig  # noqa: E402
from scnerf_tpu.fields.nerf import init_nerf_mlp as j_init_nerf_mlp  # noqa: E402
from scnerf_tpu.render import nerfpp_renderer as jrend_pp  # noqa: E402
from scnerf_tpu.render import renderer as jrend  # noqa: E402
from scnerf_tpu_torch import bridge, serve as tserve  # noqa: E402
from scnerf_tpu_torch.cli import export as tcli_export  # noqa: E402
from scnerf_tpu_torch.cli import train as tcli  # noqa: E402
from scnerf_tpu_torch.fields.nerf import NeRFConfig  # noqa: E402
from scnerf_tpu_torch.fields.nerfpp import NerfPPConfig  # noqa: E402
from scnerf_tpu_torch.kernels import _build, pdf_cuda  # noqa: E402
from scnerf_tpu_torch.render import nerfpp_renderer as trend_pp  # noqa: E402
from scnerf_tpu_torch.render import renderer as trend  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
J_MODEL = JNeRFConfig(depth=3, width=32, skips=(1,), multires=4, multires_views=2)
J_RENDER = jrend.RenderConfig(n_samples=8, n_importance=8, remat_chunk=0, near=0.5, far=2.0)
T_MODEL = bridge.convert_config(J_MODEL, NeRFConfig)
T_RENDER = bridge.convert_config(J_RENDER, trend.RenderConfig)
J_PP_MODEL = jfield_pp.NerfPPConfig(depth=2, width=16, skips=(1,), max_freq_log2=3,
                                    max_freq_log2_viewdirs=2)
J_PP_RENDER = jrend_pp.NerfPPRenderConfig(cascade_samples=(6, 6), remat_chunk=0)
T_PP_MODEL = bridge.convert_config(J_PP_MODEL, NerfPPConfig)
T_PP_RENDER = bridge.convert_config(J_PP_RENDER, trend_pp.NerfPPRenderConfig)
NDC = (24, 32, 30.0, 28.0)
BATCH = 16
JAX_KEYS = {"pipeline", "inputs", "outputs", "batch", "step", "bytes", "expname"}


@pytest.fixture(scope="module")
def weights():
    k = jax.random.key(0)
    jp = {"coarse": j_init_nerf_mlp(k, J_MODEL),
          "fine": j_init_nerf_mlp(jax.random.fold_in(k, 1), J_MODEL)}
    jl = [jfield_pp.init_nerfpp_net(jax.random.fold_in(k, 7 + m), J_PP_MODEL) for m in range(2)]
    return ((jp, bridge.tree_to_torch(jax.tree.map(np.asarray, jp), device="cpu")),
            (jl, bridge.tree_to_torch(jax.tree.map(np.asarray, jl), device="cpu")))


def _nerf_rays(n, seed=0, forward=False):
    rng = np.random.default_rng(seed)
    rays_o = (rng.normal(size=(n, 3)) * 0.1).astype(np.float32)
    rays_d = rng.normal(size=(n, 3)).astype(np.float32)
    if forward:  # in front of the NDC camera
        rays_d[:, 2] = -np.abs(rays_d[:, 2]) - 1.0
    rays_d /= np.linalg.norm(rays_d, axis=-1, keepdims=True)
    return (rays_o, rays_d, np.full((n,), 0.5, np.float32), np.full((n,), 2.0, np.float32))


def _pp_rays(n, seed=3):
    rng = np.random.default_rng(seed)
    ray_o = (rng.normal(size=(n, 3)) * 0.1).astype(np.float32)
    ray_d = rng.normal(size=(n, 3)).astype(np.float32)
    ray_d /= np.linalg.norm(ray_d, axis=-1, keepdims=True)
    return ray_o, ray_d, np.full((n,), 1e-4, np.float32)


CASES = {
    "nerf": lambda w: (tserve.make_nerf_serve_fn(w[0][1], T_MODEL, T_RENDER),
                       jserve.make_nerf_serve_fn(w[0][0], J_MODEL, J_RENDER),
                       tserve.nerf_serve_specs, jserve.nerf_serve_specs, _nerf_rays(BATCH)),
    "nerf_ndc": lambda w: (tserve.make_nerf_serve_fn(w[0][1], T_MODEL, T_RENDER, ndc=NDC),
                           jserve.make_nerf_serve_fn(w[0][0], J_MODEL, J_RENDER, ndc=NDC),
                           tserve.nerf_serve_specs, jserve.nerf_serve_specs,
                           _nerf_rays(BATCH, forward=True)),
    "nerfpp": lambda w: (tserve.make_nerfpp_serve_fn(w[1][1], T_PP_MODEL, T_PP_RENDER),
                         jserve.make_nerfpp_serve_fn(w[1][0], J_PP_MODEL, J_PP_RENDER),
                         tserve.nerfpp_serve_specs, jserve.nerfpp_serve_specs,
                         _pp_rays(BATCH)),
}


@pytest.fixture(scope="module")
def artifacts(weights):
    """Each case's serve functions and the port's artifact bytes."""
    out = {}
    for name, make in CASES.items():
        t_fn, j_fn, t_specs, j_specs, rays = make(weights)
        data = tserve.export_serving_fn(t_fn, t_specs(BATCH), device="cpu")
        out[name] = (t_fn, j_fn, j_specs, rays, data)
    return out


def _tensors(arrays):
    return [torch.from_numpy(np.asarray(x)) for x in arrays]


class TestOperatorFakes:
    @pytest.mark.parametrize("with_cdf", [True, False])
    def test_fakes_on_meta(self, with_cdf):
        n, b, s = 5, 9, 7
        bins, weights, u = (torch.empty(shape, device="meta")
                            for shape in ((n, b), (n, b - 1), (n, s)))
        out = torch.ops.scnerf_tpu_torch.sample_pdf(bins, weights, u)
        assert out.shape == (n, s) and out.dtype == torch.float32 and out.is_meta
        out, inds, cdf = torch.ops.scnerf_tpu_torch.sample_pdf_fwd(bins, weights, u, "nerfpp",
                                                                   with_cdf)
        assert out.shape == (n, s) and out.dtype == torch.float32 and out.is_meta
        assert inds.shape == (n, s) and inds.dtype == torch.int32 and inds.is_meta
        if with_cdf:
            assert cdf.shape == (n, b) and cdf.dtype == torch.float32 and cdf.is_meta
        else:
            assert cdf is None

    def test_operators_export_and_are_listed(self, monkeypatch):
        """A program that calls both operators traces through their fakes;
        a CPU artifact does not build the kernels' library."""
        class Calls(torch.nn.Module):
            def forward(self, bins, weights, u):
                a = torch.ops.scnerf_tpu_torch.sample_pdf(bins, weights, u)
                b = torch.ops.scnerf_tpu_torch.sample_pdf_fwd(bins, weights, u, "nerfpp", False)
                return a + b[0]

        args = (torch.zeros(4, 6), torch.zeros(4, 5), torch.zeros(4, 3))
        program = torch.export.export(Calls(), args, strict=False)
        ops = ["scnerf_tpu_torch.sample_pdf.default", "scnerf_tpu_torch.sample_pdf_fwd.default"]
        assert tserve.artifact_operators(program) == ops
        import io

        buffer = io.BytesIO()
        torch.export.save(program, buffer)
        monkeypatch.setattr(_build, "load", lambda name: pytest.fail("built off the card"))
        loaded = tserve.load_serving_fn(buffer.getvalue())
        assert loaded.operators == ops
        assert tserve.artifact_device(loaded.exported).type == "cpu"
        assert pdf_cuda.OPS_NAMESPACE == "scnerf_tpu_torch"


class TestArtifact:
    @pytest.mark.parametrize("case", list(CASES))
    def test_loaded_equals_serve_fn_bitwise(self, artifacts, case, tmp_path):
        t_fn, _, _, rays, data = artifacts[case]
        path = tmp_path / "serve.pt2"
        path.write_bytes(data)
        loaded = tserve.load_serving_fn(str(path))
        assert loaded.operators == []  # the CPU twins, not the operators
        got, want = loaded(*_tensors(rays)), t_fn(*_tensors(rays))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
        assert [n.meta["val"].shape for n in loaded.exported.graph.nodes
                if n.op == "placeholder" and n.name in
                loaded.exported.graph_signature.user_inputs][0] == (BATCH, 3)

    @pytest.mark.parametrize("case", list(CASES))
    def test_loaded_matches_jax_artifact(self, artifacts, case):
        _, j_fn, j_specs, rays, data = artifacts[case]
        j_loaded = jserve.load_serving_fn(jserve.export_serving_fn(j_fn, j_specs(BATCH)))
        want = j_loaded(*(jnp.asarray(x) for x in rays))
        got = tserve.load_serving_fn(data)(*_tensors(rays))
        assert set(got) == set(want)
        for k in want:
            assert_det_maps_close(got[k].numpy(), np.asarray(want[k]), k)

    @pytest.mark.parametrize("case", list(CASES))
    def test_no_random_operator(self, artifacts, case):
        loaded = tserve.load_serving_fn(artifacts[case][-1])
        assert tserve.random_operators(loaded.exported) == []

    def test_random_operator_refused(self):
        def drawing(x):
            return {"rgb": x + torch.rand_like(x)}

        with pytest.raises(RuntimeError, match="random"):
            tserve.export_serving_fn(drawing, (tserve.TensorSpec((4, 3)),), device="cpu")

    def test_loader_runs_in_float32_and_restores_the_flags(self, artifacts, monkeypatch):
        _, _, _, rays, data = artifacts["nerf"]
        loaded = tserve.load_serving_fn(data)
        seen = []
        inner = loaded.module.forward

        def recording(*args, **kwargs):
            seen.append((torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32, torch.is_inference_mode_enabled()))
            return inner(*args, **kwargs)

        monkeypatch.setattr(loaded.module, "forward", recording)
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
        loaded(*_tensors(rays))
        assert seen == [(False, False, True)]
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32

    def test_cuda_artifact_needs_a_card(self, artifacts):
        """An artifact whose constants and inputs lie on the card refuses to
        load without one, rather than run on the CPU (the archive's device
        records rewritten to ``cuda:0``, as the card's export writes them)."""
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        import io
        import zipfile

        src = zipfile.ZipFile(io.BytesIO(artifacts["nerf"][-1]))
        out = io.BytesIO()
        with zipfile.ZipFile(out, "w") as dst:
            for item in src.infolist():
                data = src.read(item.filename)
                if item.filename.endswith(".json"):
                    data = data.replace(b'{"type": "cpu", "index": null}',
                                        b'{"type": "cuda", "index": 0}')
                dst.writestr(item, data)
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            tserve.load_serving_fn(out.getvalue())

    @pytest.mark.parametrize("case", ["nerf", "nerfpp"])
    def test_service_over_loaded_artifact(self, artifacts, case):
        t_fn, _, _, _, data = artifacts[case]
        rays = _nerf_rays(37, seed=9) if case == "nerf" else _pp_rays(37, seed=9)
        got = tserve.RenderService(tserve.load_serving_fn(data), BATCH, device="cpu")(*rays)
        want = tserve.RenderService(t_fn, BATCH, device="cpu")(*rays)
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape[0] == 37
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


BLENDER_FLAGS = {"dataset_type": "blender", "white_bkgd": True, "N_rand": 32, "N_samples": 4,
                 "N_importance": 4, "netdepth": 2, "netwidth": 16, "multires": 2,
                 "multires_views": 2, "testskip": 1, "i_print": 1, "i_weights": 2}
LLFF_FLAGS = {"netdepth": 2, "netwidth": 16, "multires": 2, "multires_views": 2,
              "N_samples": 4, "N_importance": 4, "N_rand": 32, "llffhold": 4,
              "ray_loss_type": "none", "i_print": 1, "i_weights": 2}
PP_FLAGS = {"scene": "", "netdepth": 3, "netwidth": 32, "max_freq_log2": 4,
            "max_freq_log2_viewdirs": 2, "cascade_samples": "8,8", "N_rand": 32,
            "chunk_size": 128, "i_print": 1, "i_weights": 2}


def _argv(config, logs, flags):
    argv = ["--config", config, "--device", "cpu", "--basedir", str(logs)]
    for k, v in flags.items():
        argv += [f"--{k}", str(v)]
    return argv


def _restored_serve_fn(argv, pipeline, ndc):
    """The serve function of the experiment restored from its checkpoint,
    as the CLI builds it."""
    from scnerf_tpu_torch.cli.render import _restore
    from scnerf_tpu_torch.core.config import load_experiment

    cfg = load_experiment(argv[1], tcli.parse_overrides(argv[4:]))
    expdir = os.path.join(cfg.logging.basedir, cfg.logging.expname)
    if pipeline == "nerfpp":
        from scnerf_tpu_torch.train.nerfpp_driver import build_nerfpp_experiment

        exp = build_nerfpp_experiment(cfg, expdir, device="cpu")
        _restore(exp, os.path.join(expdir, "ckpts"))
        fn = tserve.make_nerfpp_serve_fn(tcli_export._detached(exp.state.params["levels"]),
                                         exp.model_cfg, exp.render_cfg)
    else:
        from scnerf_tpu_torch.train.driver import build_experiment

        exp = build_experiment(cfg, expdir, device="cpu")
        _restore(exp, os.path.join(expdir, "ckpts"))
        params = tcli_export._detached({k: exp.state.params[k] for k in ("coarse", "fine")})
        fn = tserve.make_nerf_serve_fn(params, exp.model_cfg, exp.render_cfg,
                                       ndc=tuple(ndc) if ndc else None)
    exp.logger.close()
    return fn, expdir


class TestExportCli:
    @pytest.mark.parametrize("family", ["blender", "llff", "nerfpp"])
    def test_train_then_export(self, family, tmp_path, capsys):
        root = tmp_path
        if family == "blender":
            scene = write_blender_scene(root / "scene")
            config = root / "cfg.txt"
            config.write_text(f"expname = expcli\ndatadir = {scene}\n")
            argv = _argv(str(config), root / "logs", BLENDER_FLAGS)
        elif family == "llff":
            write_llff_scene(root / "scene", n_views=9, seed=5)
            argv = _argv(os.path.join(REPO, "configs", "llff", "fern_ours.txt"), root / "logs",
                         dict(LLFF_FLAGS, datadir=root / "scene"))
        else:
            write_nerfpp_scene(root / "scene", splits=(("train", 4), ("validation", 1)),
                               H=16, W=20)
            argv = _argv(os.path.join(REPO, "configs", "tanks_and_temples",
                                      "tat_training_Truck_ours.txt"), root / "logs",
                         dict(PP_FLAGS, datadir=root / "scene"))
        assert tcli.main(argv + ["--steps", "2"]) == 0
        out = str(root / "serve.pt2")
        assert tcli_export.main(argv + ["--out", out, "--batch", "64"]) == 0
        assert "[export] step 2 ->" in capsys.readouterr().out
        meta = json.loads((root / "serve.pt2.json").read_text())
        pipeline = "nerfpp" if family == "nerfpp" else "nerf"
        assert JAX_KEYS | {"device", "operator_library"} <= set(meta)
        assert meta["pipeline"] == pipeline and meta["batch"] == 64 and meta["step"] == 2
        assert meta["bytes"] == os.path.getsize(out)
        assert meta["device"] == "cpu" and meta["operator_library"] is None
        if pipeline == "nerf":
            assert ("ndc" in meta) and ((meta["ndc"] is not None) == (family == "llff"))
        fn, _ = _restored_serve_fn(argv, pipeline, meta.get("ndc"))
        rays = (_pp_rays(64, seed=4) if pipeline == "nerfpp"
                else _nerf_rays(64, seed=4, forward=family == "llff"))
        got = tserve.load_serving_fn(out)(*_tensors(rays))
        want = fn(*_tensors(rays))
        assert list(got) == meta["outputs"]
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)

    def test_default_path_and_no_card(self, tmp_path):
        scene = write_blender_scene(tmp_path / "scene")
        config = tmp_path / "cfg.txt"
        config.write_text(f"expname = expdef\ndatadir = {scene}\n")
        argv = _argv(str(config), tmp_path / "logs", BLENDER_FLAGS)
        assert tcli_export.main(argv + ["--batch", "8"]) == 0  # no checkpoint: initial weights
        assert (tmp_path / "logs" / "expdef" / "serve.pt2").exists()
        if not torch.cuda.is_available():
            assert tcli_export.main(["--config", str(config), "--device", "cuda"]) == 2
