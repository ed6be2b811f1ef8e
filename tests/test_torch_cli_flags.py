"""The sampling commands' flags: JAX's ``sample``, ``fid``, ``nfe`` and
``time`` command lines parsed by the port's parser give the ``Config`` that
``lfm_tpu.cli.main._resolve_config`` gives, field for field, ``--datadir``
and ``--fused_dit`` among them. The multi-process flags (``--coordinator``,
``--num_procs``, ``--process_id``) are tests/test_torch_multihost.py's and
stay out of these lines.
"""

import dataclasses
import os

import pytest

jax = pytest.importorskip("jax")

from tests.torch_parity import leaves_process_as_found  # noqa: E402,F401

from lfm_tpu.cli import main as jcli  # noqa: E402
from lfm_tpu_torch.cli import main as tcli  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGFILE = os.path.join(REPO, "test_args", "celeb256_dit.txt")

LINES = {
    "preset": ["--preset", "celeb256_dit"],
    "fused_dit_over_argfile": ["--argfile", ARGFILE, "--fused_dit", "--datadir", "/data/celeba"],
    "no_fused_dit": ["--preset", "imnet_dit", "--no_fused_dit", "--cfg_scale", "1.5",
                     "--datadir", "d", "--dataset", "imnet"],
    "overrides": ["--preset", "celeb256_adm", "--method", "euler", "--steps", "8", "--atol",
                  "1e-4", "--rtol", "1e-3", "--batch_size", "4", "--seed", "7", "--epoch_id",
                  "3", "--n_sample", "9", "--generator", "determ-indiv", "--real_img_dir",
                  "s.npz", "--output_log", "log.txt", "--exp", "e", "--nf", "64",
                  "--ch_mult", "1", "2", "--attn_resolutions", "2", "--num_res_blocks", "1",
                  "--image_size", "64", "--eval_noise", "auto", "--use_karras_samplers",
                  "--int8_dit", "--scale_factor", "0.2", "--sp", "1", "--pp", "1",
                  "--pp_chunks", "1"],
    "argfile_only": ["--argfile", os.path.join(REPO, "test_args", "imnet_adm.txt"),
                     "--eval_noise", "0.001", "--label_dropout", "0.1", "--num_classes", "10",
                     "--model_type", "adm_context", "--use_origin_adm"],
}


@pytest.mark.parametrize("line", sorted(LINES))
@pytest.mark.parametrize("cmd", ["sample", "fid", "nfe", "time"])
def test_jax_sampling_command_lines_give_jax_config(cmd, line):
    argv = [cmd, *LINES[line]]
    want = jcli._resolve_config(jcli._build_parser().parse_args(argv))
    got = tcli._resolve_config(tcli._build_parser().parse_args(argv))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if line == "fused_dit_over_argfile":
        assert got.sample.use_fused_dit is True and got.data.datadir == "/data/celeba"


def test_fused_dit_flags_exclude_each_other():
    """Both parsers refuse --fused_dit with --no_fused_dit; each wins over an
    argfile or preset that set the other."""
    for parser in (jcli._build_parser(), tcli._build_parser()):
        with pytest.raises(SystemExit):
            parser.parse_args(["sample", "--fused_dit", "--no_fused_dit"])
    for flag, want in (("--fused_dit", True), ("--no_fused_dit", False)):
        for preset in ("celeb256_dit", "imnet_dit"):
            args = tcli._build_parser().parse_args(["sample", "--preset", preset, flag])
            assert tcli._resolve_config(args).sample.use_fused_dit is want
