"""The port's generate CLI accepts every flag of the JAX CLI, each with the
JAX CLI's meaning (``magcache_tpu/cli/generate.py``), at tiny shapes on the
CPU."""

import pytest

from magcache_tpu.cli.generate import build_parser as jax_build_parser
from magcache_tpu_torch.cli import generate as G

NO_OPS = ["--convert_model_dtype", "--flow_reverse", "--use_cpu_offload",
          "--enable_model_cpu_offload", "--enable_sequential_cpu_offload",
          "--enable_group_offload", "--t5_fsdp", "--dit_fsdp", "--t5_cpu",
          "--num_images_per_prompt", "2", "--max_input_image_pixels", "1048576",
          "--offload_model", "True", "--dp", "1", "--tp", "1"]
NO_OP_KEYS = {"convert_model_dtype", "flow_reverse", "use_cpu_offload",
              "enable_model_cpu_offload", "enable_sequential_cpu_offload",
              "enable_group_offload", "t5_fsdp", "dit_fsdp", "t5_cpu",
              "num_images_per_prompt", "max_input_image_pixels", "offload_model",
              "dp", "tp"}


def _options(parser) -> set:
    return {o for act in parser._actions for o in act.option_strings}


def _resolved(argv):
    parser = G.build_parser()
    args = parser.parse_args(argv)
    G.resolve_aliases(args, parser)
    return args


def test_every_jax_option_string_is_known_to_the_port():
    missing = _options(jax_build_parser()) - _options(G.build_parser())
    assert not missing, f"JAX CLI flags the port refuses: {sorted(missing)}"


@pytest.mark.parametrize("argv,want", [([], 0), (["--seed", "7"], 7),
                                       (["--seed", "7", "--base_seed", "3"], 3),
                                       (["--base_seed", "3"], 3)])
def test_seed_sets_base_seed_unless_base_seed_is_given(argv, want):
    assert _resolved(argv).base_seed == want


@pytest.mark.parametrize("argv,want", [([], False), (["--enable_magcache"], True),
                                       (["--use_magcache"], True)])
def test_enable_magcache_sets_use_magcache(argv, want):
    assert _resolved(argv).use_magcache is want


def test_open_sora_scores_and_seed_reach_generate(monkeypatch, tmp_path):
    from magcache_tpu_torch.pipelines.open_sora import OpenSoraPipeline

    seen = {}
    real = OpenSoraPipeline.generate

    def spy(self, prompt, **kw):
        seen.update(kw, prompt=self._prompt(prompt, kw["aes"], kw["flow"],
                                            kw["camera_motion"], True))
        return real(self, prompt, **kw)

    monkeypatch.setattr(OpenSoraPipeline, "generate", spy)
    G.main(["--task", "open-sora", "--tiny", "--device", "cpu", "--sample_steps", "2",
            "--aes", "5.5", "--flow_score", "3.0", "--camera_motion", "pan right",
            "--seed", "11", "--prompt", "a fox", "--save_file", str(tmp_path / "os")])
    assert (seen["aes"], seen["flow"], seen["camera_motion"], seen["seed"]) == (
        5.5, 3.0, "pan right", 11)
    assert "aesthetic score: 5.5" in seen["prompt"] and "pan right" in seen["prompt"]
    assert (tmp_path / "os_latents.npy").exists()
    assert G.build_parser().parse_args([]).aes == 6.5       # the JAX default


@pytest.mark.parametrize("argv,ulysses,ring", [
    (["--ulysses_degree", "2"], 2, None),
    (["--ring_degree", "2"], None, 2),
    (["--ring_degree", "1"], None, None),                    # 1 selects no ring
    (["--ulysses_size", "4", "--ulysses_degree", "2"], 4, None),
    (["--ring_size", "4", "--ring_degree", "2"], None, 4)])
def test_degree_aliases_fill_the_sp_sizes(argv, ulysses, ring):
    args = _resolved(argv)
    assert (args.ulysses_size, args.ring_size) == (ulysses, ring)


def test_prompt_extend_keeps_the_raw_prompt(capsys, tmp_path):
    args = _resolved(["--prompt", "a cat", "--use_prompt_extend"])
    G.extend_prompt(args)
    assert args.prompt == "a cat"
    assert "needs --prompt_extend_model" in capsys.readouterr().out
    args = _resolved(["--prompt", "a cat", "--use_prompt_extend",
                      "--prompt_extend_model", str(tmp_path / "no_model")])
    G.extend_prompt(args)
    assert args.prompt == "a cat"
    assert "Extending prompt failed" in capsys.readouterr().out
    args = _resolved(["--prompt", "a cat", "--prompt_extend_model", str(tmp_path)])
    G.extend_prompt(args)                                    # not asked: nothing
    assert args.prompt == "a cat" and capsys.readouterr().out == ""


def test_parity_no_ops_parse_and_change_nothing():
    base = vars(_resolved(["--task", "latte"]))
    with_no_ops = vars(_resolved(["--task", "latte", *NO_OPS]))
    assert {k: v for k, v in with_no_ops.items() if k not in NO_OP_KEYS} == {
        k: v for k, v in base.items() if k not in NO_OP_KEYS}


@pytest.mark.parametrize("argv,want", [([], "cuda"), (["--cpu"], "cpu"),
                                       (["--device", "cpu"], "cpu")])
def test_cpu_is_device_cpu(argv, want):
    assert _resolved(argv).device == want


@pytest.mark.parametrize("flag", ["--dp", "--tp"])
def test_dp_tp_above_one_exit_naming_the_roadmap(flag, monkeypatch):
    """``--dp`` and ``--tp`` run on Wan (one process a rank, under torchrun;
    the two-process run is tests/test_torch_tp_wan.py's); the refusals that
    stay: another family names the roadmap item, and no launcher names
    torchrun."""
    assert getattr(_resolved([flag, "2"]), flag[2:]) == 2
    with pytest.raises(SystemExit, match=r"ROADMAP section 1 item 2"):
        G.main(["--task", "open-sora", "--tiny", "--device", "cpu", flag, "4"])
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit, match=r"one process per rank \(4\): start them with "
                                         r"torchrun"):
        G.main(["--task", "t2v-1.3B", "--tiny", "--device", "cpu", flag, "4"])
