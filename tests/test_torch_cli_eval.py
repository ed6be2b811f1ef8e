"""Port parity of the reference's evaluation modes: ``sample/sharded.py``'s
``compute_fid`` and the CLI's ``fid``, ``nfe`` and ``time`` subcommands,
against lfm_tpu on the CPU at test scale.

The JAX side is handed the port's own ``SampleRNG`` noise and labels as
numpy (the two RNGs cannot share bits), and runs JAX's sampler, VAE,
Inception and ``fid_from_activations`` on the same weights. The statistics
file is written in the test from seeded activations with a full-rank
covariance.

Tolerances: in f32 the pool3 activations within 1e-4 of the largest (f32
convolutions summed in another order over the ODE, the VAE and 95
Inception layers) and the FID within 1e-3 relative (the same scipy
arithmetic on those statistics); the ``fid`` command's activations equal,
bit for bit, ``generate_fid_activations`` on the weights the command
builds; ``nfe`` prints JAX's integer on the same bf16 weights and noise.
"""

import dataclasses
import os
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
# lfm_tpu's make_sampler imports pallas lazily, and that import sets CUDA_ROOT
# in os.environ; import it with the module, before the state guard looks
import jax.experimental.pallas  # noqa: E402,F401
import torch  # noqa: E402

from tests.torch_parity import leaves_process_as_found, randomize, rel_err  # noqa: E402,F401

from lfm_tpu.core import config as jconfig  # noqa: E402
from lfm_tpu.eval import fid as jfid  # noqa: E402
from lfm_tpu.eval.inception import FIDInceptionV3 as JInception  # noqa: E402
from lfm_tpu.eval.inception import convert_inception_state_dict  # noqa: E402
from lfm_tpu.nn.convert_edm import convert_edm_state_dict  # noqa: E402
from lfm_tpu.nn.factory import create_network as jcreate_network  # noqa: E402
from lfm_tpu.sample.sample import make_sampler as jmake_sampler  # noqa: E402
from lfm_tpu.sample.sample import sample_latents as jsample_latents  # noqa: E402
from lfm_tpu.vae.autoencoder_kl import AutoencoderKL as JVAE  # noqa: E402
from lfm_tpu_torch.cli import main as cli  # noqa: E402
from lfm_tpu_torch.core import config as tconfig  # noqa: E402
from lfm_tpu_torch.core.rng import SampleRNG  # noqa: E402
from lfm_tpu_torch.eval.fid import save_statistics  # noqa: E402
from lfm_tpu_torch.eval.inception import seeded_inception_state_dict  # noqa: E402
from lfm_tpu_torch.nn.factory import create_network  # noqa: E402
from lfm_tpu_torch.nn.init import seeded_init_  # noqa: E402
from lfm_tpu_torch.sample import sample as tsample  # noqa: E402
from lfm_tpu_torch.sample import sharded  # noqa: E402
from lfm_tpu_torch.sample.sample import noise_and_labels  # noqa: E402
from lfm_tpu_torch.vae.autoencoder_kl import create_vae  # noqa: E402
from lfm_tpu_torch.vae.convert import vae_params_from_jax  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# test-scale overrides of the CLI: a DiT-T/2 or a two-level UNet on 4x4
# latents (32 px images through the full-size VAE)
DIT_FLAGS = ["--model_type", "DiT-T/2", "--image_size", "32"]
UNET_FLAGS = ["--image_size", "32", "--nf", "32", "--ch_mult", "1", "2",
              "--attn_resolutions", "2", "--num_res_blocks", "1"]


@pytest.fixture(scope="module")
def stats_path(tmp_path_factory):
    """Statistics of 3000 seeded activations (a full-rank covariance) at
    about the seeded Inception's scale."""
    rng = np.random.default_rng(0)
    acts = 40.0 * rng.standard_normal((3000, 2048)) + 20.0
    path = str(tmp_path_factory.mktemp("stats") / "stats.npy")
    save_statistics(path, acts.mean(axis=0), np.cov(acts, rowvar=False))
    return path


def _capture_activations(monkeypatch):
    """Record the activations that compute_fid scores."""
    seen = []
    real = sharded.fid_from_activations

    def record(acts, path):
        seen.append(acts.copy())
        return real(acts, path)

    monkeypatch.setattr(sharded, "fid_from_activations", record)
    return seen


def _edm_configs():
    """imnet_adm at test scale in both packages: 16x16 latents of 32 px
    images (f = 2), 10 classes, CFG 1.25, euler at 2 steps, 5 samples in
    batches of 2 (the last padded)."""
    out = []
    for mod in (jconfig, tconfig):
        c = mod.get_preset("imnet_adm")
        model = dataclasses.replace(c.model, image_size=32, f=2, nf=32, ch_mult=(1, 2),
                                    num_res_blocks=1, attn_resolutions=(8,), num_classes=10,
                                    label_dim=10)
        sample = dataclasses.replace(c.sample, method="euler", num_steps=2, n_sample=5,
                                     batch_size=2)
        out.append(dataclasses.replace(c, model=model, sample=sample))
    return out


def test_compute_fid_matches_jax(stats_path, tmp_path, monkeypatch):
    """compute_fid on an f32 EDM with CFG, a small VAE and seeded Inception
    weights, n_sample not a multiple of the batch, against JAX's sampler,
    VAE, Inception and fid_from_activations on the port's noise and labels;
    save_dir holds one {index}.jpg per sample."""
    cfg_j, cfg_t = _edm_configs()
    assert cfg_t.sample.cfg_scale == 1.25
    tm = seeded_init_(create_network(cfg_t.model, device="cpu"), 1)
    jm = jcreate_network(cfg_j.model)
    mparams = convert_edm_state_dict(tm.state_dict())
    jv = JVAE(block_out=(32, 32))
    vparams = randomize(jv.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)),
                                jax.random.PRNGKey(1)), 4)
    tv = create_vae((32, 32), device="cpu")
    tv.load_state_dict(vae_params_from_jax(vparams))
    inception = seeded_inception_state_dict(3)

    seen = _capture_activations(monkeypatch)
    jpg = tmp_path / "jpg"
    fid = sharded.compute_fid(cfg_t, tm, None, tv, None, inception, stats_path,
                              save_dir=str(jpg), device="cpu")
    assert sorted(os.listdir(jpg)) == [f"{i}.jpg" for i in range(5)]

    sc = cfg_t.sample
    rng = SampleRNG(seed=sc.seed, num_samples=sc.n_sample)
    jsampler = jmake_sampler(cfg_j, jm, mparams, jv, vparams, jit=True)
    jinception = jax.jit(JInception().apply)
    iparams = convert_inception_state_dict(inception)
    want = np.zeros((5, 2048), np.float32)
    for step in range(3):
        idx = rng.batch_indices(done=2 * step, batch=2)
        noise, y = noise_and_labels(cfg_t, rng, idx, device="cpu")
        out = jsampler(jnp.asarray(noise.numpy()), jnp.asarray(y.numpy()))
        want[idx.numpy()] = np.asarray(jinception(iparams, out.images))
    assert idx.tolist() == [4, 4]  # the last batch is padded with the last index
    assert rel_err(seen[0], want) < 1e-4
    want_fid = jfid.fid_from_activations(want, stats_path)
    assert np.isfinite(fid) and abs(fid - want_fid) <= 1e-3 * abs(want_fid)


def test_fid_command_prints_logs_and_scores_what_it_generates(stats_path, tmp_path, capsys,
                                                              monkeypatch):
    """``cli.main fid`` on celeb256_dit at test scale prints ``FID = x`` and
    appends the reference's ``Epoch = E, FID = x`` line to --output_log;
    the activations it scores are generate_fid_activations' on the seeded
    weights it builds (3 samples in batches of 2)."""
    log = tmp_path / "log.txt"
    log.write_text("Epoch = 6, FID = 1.5\n")
    seen = _capture_activations(monkeypatch)
    fid = cli.main(["fid", "--preset", "celeb256_dit", "--device", "cpu", *DIT_FLAGS,
                    "--method", "euler", "--steps", "2", "--n_sample", "3", "--batch_size", "2",
                    "--real_img_dir", stats_path, "--output_log", str(log), "--epoch_id", "7"])
    out, err = capsys.readouterr()
    assert f"FID = {fid}\n" in out and np.isfinite(fid)
    assert log.read_text() == f"Epoch = 6, FID = 1.5\nEpoch = 7, FID = {fid}\n"
    assert "seeded random Inception weights" in err

    config = cli._resolve_config(cli._build_parser().parse_args(
        ["fid", "--preset", "celeb256_dit", *DIT_FLAGS, "--method", "euler", "--steps", "2",
         "--n_sample", "3", "--batch_size", "2"]))
    model = seeded_init_(create_network(config.model, dtype=torch.bfloat16, use_flash=True,
                                        device="cpu"), 0)
    vae = seeded_init_(create_vae(dtype=torch.bfloat16, device="cpu"), 1)
    acts = sharded.generate_fid_activations(config, model, None, vae, None,
                                            seeded_inception_state_dict(0), device="cpu")
    assert acts.shape == (3, 2048)
    np.testing.assert_array_equal(seen[0], acts)


def test_nfe_command_matches_jax(capsys):
    """``cli.main nfe`` on imnet_adm at test scale (bf16, CFG 1.25, dopri5
    at 1e-3, batch 1) prints the integer JAX's sampler gives on the same
    seeded weights and the port's noise and labels."""
    flags = ["--preset", "imnet_adm", *UNET_FLAGS, "--atol", "1e-3", "--rtol", "1e-3",
             "--n_sample", "2"]
    nfes = cli.main(["nfe", "--device", "cpu", *flags])
    trials = len(nfes)
    assert f"Average NFE over 2 trials: {int(sum(nfes) / trials)}\n" in capsys.readouterr().out

    config = cli._resolve_config(cli._build_parser().parse_args(["nfe", *flags]))
    tm = seeded_init_(create_network(config.model, dtype=torch.bfloat16, device="cpu"), 0)
    m = config.model
    jmodel = dataclasses.replace(jconfig.get_preset("imnet_adm").model, image_size=32, nf=32,
                                 ch_mult=(1, 2), attn_resolutions=(2,), num_res_blocks=1)
    assert dataclasses.asdict(jmodel) == dataclasses.asdict(m)
    cfg_j = dataclasses.replace(jconfig.get_preset("imnet_adm"), model=jmodel,
                                sample=dataclasses.replace(jconfig.get_preset("imnet_adm").sample,
                                                           atol=1e-3, rtol=1e-3, n_sample=2))
    jm = jcreate_network(jmodel, dtype=jnp.bfloat16)
    jsampler = jmake_sampler(cfg_j, jm, convert_edm_state_dict(tm.state_dict()), jit=True)
    rng = SampleRNG(seed=config.sample.seed, num_samples=2)
    want = []
    for i in range(trials):
        noise, y = noise_and_labels(config, rng, [i], device="cpu")
        want.append(float(jsampler(jnp.asarray(noise.numpy()), jnp.asarray(y.numpy())).nfe))
    assert nfes == want and min(nfes) > 6


def test_time_command_prints_its_format(capsys):
    """``time``: one warm-up, then --n_sample timed repetitions at batch 1,
    printed as the reference prints them."""
    res = cli.main(["time", "--preset", "celeb256_dit", "--device", "cpu", *DIT_FLAGS,
                    "--method", "euler", "--steps", "2", "--n_sample", "2"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(r"Inference time: \d+\.\d\d\+/-\d+\.\d\dms", line), line
    assert len(res["ms"]) == 2 and res["nfe"] == [2.0, 2.0, 2.0]
    assert line == f"Inference time: {np.mean(res['ms']):.2f}+/-{np.std(res['ms']):.2f}ms"


@pytest.mark.parametrize("argfile", sorted(os.listdir(os.path.join(REPO, "test_args"))))
def test_nfe_runs_every_released_argfile(argfile, capsys):
    """Each of the 11 released argfiles builds its network (DiT, origin ADM
    or EDM's DhariwalUNet, with CFG where the argfile sets it) at test
    scale and samples through ``nfe`` on the CPU."""
    path = os.path.join(REPO, "test_args", argfile)
    flags = DIT_FLAGS if "DiT" in tconfig.load_argfile(path).model.model_type else UNET_FLAGS
    nfes = cli.main(["nfe", "--argfile", path, "--device", "cpu", *flags, "--method", "euler",
                     "--steps", "1", "--n_sample", "1"])
    assert nfes == [1.0]
    assert "Average NFE over 1 trials: 1\n" in capsys.readouterr().out


@pytest.mark.parametrize("generator", ["determ", "determ-indiv"])
def test_per_sample_generators_run(generator, capsys):
    """determ and determ-indiv both name SampleRNG (lfm_tpu/core/rng.py:88)."""
    nfes = cli.main(["nfe", "--preset", "celeb256_dit", "--device", "cpu", *DIT_FLAGS,
                     "--method", "euler", "--steps", "1", "--n_sample", "1",
                     "--generator", generator])
    assert nfes == [1.0]
    assert "Average NFE over 1 trials: 1\n" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [["--sp", "2"], ["--pp", "2"], ["--pp_chunks", "2"],
                                   ["--num_procs", "2"], ["--generator", "dummy"]])
def test_unported_flags_raise(flags):
    """The mesh flags are JAX's: one process asked for ``sample --sp 2`` or
    ``--pp 2`` raises the mesh's rank-count error, and ``--pp_chunks`` and
    every subcommand's mesh flags parse as JAX's parser parses them (fid,
    nfe and time ignore them, as JAX's do). The stateful dummy generator
    (item 9) raises rather than being ignored; more than one process exits
    with JAX's message where the subcommand has no multi-process story,
    and ``fid`` without a coordinator raises."""
    if flags[0] in ("--sp", "--pp", "--pp_chunks"):
        for cmd in ("sample", "fid", "nfe", "time"):
            argv = [cmd, "--preset", "celeb256_dit", *flags]
            if cmd == "sample" and flags[0] != "--pp_chunks":
                with pytest.raises(ValueError, match="1 ranks are not divisible"):
                    cli.main([*argv, "--device", "cpu"])
            mesh = cli._resolve_config(cli._build_parser().parse_args(argv)).mesh
            assert dataclasses.asdict(mesh) == dataclasses.asdict(
                _jax_sample_config(argv, part="mesh"))
            assert getattr(mesh, flags[0][2:]) == 2
        return
    item = {"--generator": "item 9"}.get(flags[0])
    for cmd in ("sample", "fid", "nfe", "time"):
        if flags[0] == "--num_procs":
            error, item = ((ValueError, "coordinator") if cmd == "fid"
                           else (SystemExit, "not supported"))
        else:
            error = NotImplementedError
        with pytest.raises(error, match=item):
            cli.main([cmd, "--preset", "celeb256_dit", "--device", "cpu", *flags])


def _jax_sample_config(argv, part="sample"):
    """The SampleConfig (or the config's ``part``) that lfm_tpu's CLI parser
    gives the same command."""
    from lfm_tpu.cli import main as jcli

    return getattr(jcli._resolve_config(jcli._build_parser().parse_args(argv)), part)


def test_karras_sample_writes_the_jax_file(tmp_path, monkeypatch, capsys):
    """``sample --use_karras_samplers --method heun --steps 4`` writes
    JAX's Karras grid name, samples_{dataset}_heun_4.jpg
    (lfm_tpu/cli/main.py:508), at JAX's NFE: 3 pairs, each corrected."""
    pytest.importorskip("PIL")
    monkeypatch.chdir(tmp_path)
    argv = ["sample", "--preset", "celeb256_dit", *DIT_FLAGS, "--use_karras_samplers",
            "--method", "heun", "--steps", "4", "--batch_size", "2"]
    path = cli.main([*argv, "--device", "cpu"])
    jsc = _jax_sample_config(argv)
    assert (jsc.use_karras_samplers, jsc.method, jsc.num_steps) == (True, "heun", 4)
    assert path == f"./samples_{jconfig.get_preset('celeb256_dit').dataset}_heun_4.jpg"
    assert (tmp_path / path).is_file()
    assert f"Samples are saved at {path} (NFE 6)" in capsys.readouterr().out


def test_nfe_with_karras_samplers_prints_jax_nfe(capsys):
    """``nfe --use_karras_samplers`` at 41 steps, past the 39-pair guard:
    JAX's count, 2 x 39 + 1, from its own sample_latents."""
    nfes = cli.main(["nfe", "--preset", "celeb256_dit", "--device", "cpu", *DIT_FLAGS,
                     "--use_karras_samplers", "--method", "heun", "--steps", "41",
                     "--n_sample", "1"])
    _, want = jsample_latents(lambda t, x: x, jnp.zeros((1, 4, 4, 4)), method="heun",
                              num_steps=41, use_karras=True)
    assert nfes == [float(want)] == [79.0]
    assert "Average NFE over 1 trials: 79\n" in capsys.readouterr().out


@pytest.mark.parametrize("value", ["auto", "0.01"])
def test_eval_noise_flag_reaches_make_sampler_as_jax_parses_it(monkeypatch, value):
    """``--eval_noise auto`` and ``--eval_noise 0.01`` reach make_sampler
    as JAX's parser gives them ("auto", or the float), and the sampler
    floors bosh3 with it."""
    seen = []
    real = cli.make_sampler

    def recording(config, model, *args, **kwargs):
        seen.append(tsample.resolve_eval_noise(config.sample, model))
        return real(config, model, *args, **kwargs)

    monkeypatch.setattr(cli, "make_sampler", recording)
    argv = ["nfe", "--preset", "celeb256_dit", *DIT_FLAGS, "--method", "bosh3", "--atol",
            "1e-3", "--rtol", "1e-3", "--eval_noise", value, "--n_sample", "1"]
    nfes = cli.main([*argv, "--device", "cpu"])
    want = _jax_sample_config(argv).eval_noise
    assert seen == [want] and type(seen[0]) is type(want)
    assert want == ("auto" if value == "auto" else 0.01)
    assert nfes[0] >= 2 + 3 + (value == "auto")


def test_fid_needs_statistics_and_one_device():
    """fid needs the statistics; its batch splits over the data axis alone,
    and one process cannot lay out a mesh with sequence parallelism (the
    mesh's rank-count error, as JAX's with too few devices)."""
    from lfm_tpu_torch.core.sharding import AXES, Mesh, make_mesh

    with pytest.raises(SystemExit, match="real_img_dir"):
        cli.main(["fid", "--preset", "celeb256_dit", "--device", "cpu", *DIT_FLAGS])
    with pytest.raises(ValueError, match="1 ranks are not divisible by fsdp\\*pp\\*tp\\*sp=2"):
        make_mesh(sp=2)
    tp_mesh = Mesh(dict(zip(AXES, (1, 1, 1, 2, 1))), {a: 0 for a in AXES})
    with pytest.raises(ValueError, match="data axis"):
        sharded.make_sharded_generator(tconfig.get_preset("celeb256_dit"), None, mesh=tp_mesh,
                                       device="cpu")
