"""The port's CLI: same flags, prints and output file as farms_tpu.cli."""
import numpy as np
import pytest
import torch

from farms_tpu_torch import cli as tcli
from farms_tpu_torch.events.io import (read_flow_txt, synthetic_translating_bar,
                                       write_events_txt)

torch.set_num_threads(1)


def _events_file(tmp_path, name="events", n=900):
    ev = synthetic_translating_bar(width=64, height=64, bar_len=24,
                                   duration_us=40000, jitter_us=15,
                                   seed=2)[:n]
    base = str(tmp_path / name)
    write_events_txt(ev, base)
    return ev, base


_POINT = ["--width", "64", "--height", "64", "--chunk-size", "256",
          "--sub-phases", "2", "--wire", "f16", "--steps-per-scan", "2"]


def test_cli_matches_jax_cli(tmp_path, capsys):
    pytest.importorskip("jax")
    from farms_tpu import cli as jcli

    ev, base = _events_file(tmp_path)
    assert jcli.main(["--filename", base, *_POINT]) == 0
    want = read_flow_txt(base + "_FARMSOut_batch.txt")
    jax_out = capsys.readouterr().out
    assert tcli.main(["--filename", base, *_POINT, "--device", "cpu"]) == 0
    got = read_flow_txt(base + "_FARMSOut_batch.txt")
    out = capsys.readouterr().out
    assert len(got) == len(want) == len(ev)
    for col in ("x", "y", "t", "pol", "scale"):
        np.testing.assert_array_equal(getattr(got, col), getattr(want, col),
                                      err_msg=col)
    np.testing.assert_array_equal(got.r_local > 0, want.r_local > 0)
    assert (want.r_local > 0).mean() > 0.3
    valid = want.r_local > 0
    np.testing.assert_allclose(got.r_true[valid], want.r_true[valid],
                               rtol=2e-3)
    # the same prints, line for line, up to the measured duration
    strip = [ln for ln in jax_out.splitlines() if "[Benchmark Main]" not in ln]
    assert [ln for ln in out.splitlines()
            if "[Benchmark Main]" not in ln] == strip
    assert "[Benchmark Main] : Processing time" in out


def test_parser_defaults_match_reference():
    # reference defaults: main.cpp:21-31
    args = tcli.build_parser().parse_args(["--filename", "f"])
    assert args.height == 320 and args.width == 320
    assert args.filtersize == 3
    assert args.inlierCheck == 5
    assert args.num_events is None
    assert args.device == "cuda"


def test_default_operating_point_by_device():
    p = tcli.build_parser()
    on_card = tcli._resolve_operating_point(p.parse_args(["--filename", "f"]))
    on_cpu = tcli._resolve_operating_point(
        p.parse_args(["--filename", "f", "--device", "cpu"]))
    assert on_card == (131072, 2, 0, 1, 0, False, "f16")
    assert on_cpu == (4096, 1, 0, 1, 0, False, "f32")
    exact = tcli._resolve_operating_point(
        p.parse_args(["--filename", "f", "--preset", "benchmark",
                      "--chunk-size", "1"]))
    assert exact[:4] == (1, 1, 0, 1) and exact[-1] == "f16"


def test_benchmark_preset_runs_on_cpu(tmp_path, capsys):
    ev, base = _events_file(tmp_path, "bench", n=600)
    assert tcli.main(["--filename", base, "--width", "64", "--height", "64",
                      "--preset", "benchmark", "--device", "cpu"]) == 0
    got = read_flow_txt(base + "_FARMSOut_batch.txt")
    assert len(got) == len(ev)
    assert (got.r_local > 0).sum() > 100
    assert "events/sec" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [
    ["--preset", "fidelity"], ["--snapshots", "2"],
    ["--preset", "benchmark", "--correction", "16", "--correction-chain",
     "full", "--snapshots", "4"],
    ["--sub-phases", "2", "--aperture-sub-phases", "4"],
    ["--sub-phases", "2", "--aperture-sub-phases", "1"],
    ["--filtersize", "7", "--sub-phases", "2"],
    ["--backend", "perevent"],
])
def test_fidelity_modes_run(tmp_path, capsys, flags):
    ev, base = _events_file(tmp_path, "fid", n=600)
    assert tcli.main(["--filename", base, "--width", "64", "--height", "64",
                      "--device", "cpu", "--chunk-size", "128", *flags]) == 0
    got = read_flow_txt(base + "_FARMSOut_batch.txt")
    assert len(got) == len(ev)
    assert (got.r_local > 0).sum() > 100
    assert "events/sec" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [
    ["--engine", "spatial"],
    ["--SERIAL", "1", "--engine", "halo", "--devices", "2"],
    ["--SERIAL", "1", "--engine", "dp", "--devices", "2"],
    ["--SERIAL", "1", "--devices", "2"],
    ["--SERIAL", "1", "--engine", "multihost", "--devices", "4"],
])
def test_unported_modes_raise(tmp_path, flags):
    """Still refused: spatial tiling (not ported) and --SERIAL 1 on more
    than one rank, for every engine."""
    _, base = _events_file(tmp_path, "x", n=10)
    with pytest.raises(NotImplementedError):
        tcli.main(["--filename", base, "--width", "64", "--height", "64",
                   "--device", "cpu", "--chunk-size", "64", *flags])


def test_serial_on_a_launched_world_raises(tmp_path, monkeypatch):
    """--SERIAL 1 --multihost in a launcher's world of 2 is refused before
    the world is joined."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    _, base = _events_file(tmp_path, "x", n=10)
    with pytest.raises(NotImplementedError):
        tcli.main(["--filename", base, "--width", "64", "--height", "64",
                   "--device", "cpu", "--SERIAL", "1", "--multihost"])


@pytest.fixture(scope="module")
def single_file(tmp_path_factory):
    """(events base path, the single engine's output file's text) of the
    sharded-engine CLI cases' stream."""
    tmp = tmp_path_factory.mktemp("engines")
    _, base = _events_file(tmp, "engines", n=700)
    assert tcli.main(["--filename", base, *_POINT, "--device", "cpu",
                      "--steps-per-scan", "1"]) == 0
    with open(base + "_FARMSOut_batch.txt") as f:
        return base, f.read()


@pytest.mark.parametrize("flags", [
    # refused before the dp and multihost engines were ported
    ["--engine", "dp"], ["--devices", "2"], ["--multihost"],
    ["--engine", "multihost"],
    ["--engine", "dp", "--devices", "2"],
    ["--engine", "single", "--devices", "2"],
    ["--engine", "multihost", "--devices", "2"],
    ["--engine", "multihost", "--devices", "1"],
])
def test_sharded_engines_write_the_single_engines_file(single_file, capfd,
                                                       flags):
    """dp (also --engine single with --devices > 1), multihost and
    --multihost without a launcher (a world of one) write the single
    engine's file byte for byte on gloo ranks; --devices 0 on the CPU is
    one rank; rank 0 alone prints."""
    base, want = single_file
    capfd.readouterr()
    assert tcli.main(["--filename", base, *_POINT, "--device", "cpu",
                      "--steps-per-scan", "1", *flags]) == 0
    assert capfd.readouterr().out.count("[Benchmark Main]") == 1
    with open(base + "_FARMSOut_batch.txt") as f:
        assert f.read() == want


def test_devices_zero_counts_the_cards(monkeypatch):
    """--devices 0 is every visible card on cuda (for dp, halo and
    multihost) and one rank on the CPU; the single engine stays one
    rank."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    p = tcli.build_parser()

    def ranks(*flags):
        return tcli._spawned_ranks(p.parse_args(["--filename", "f", *flags]))

    for engine in ("dp", "halo", "multihost"):
        assert ranks("--engine", engine) == 4
        assert ranks("--engine", engine, "--device", "cpu") == 1
        assert ranks("--engine", engine, "--devices", "2") == 2
    assert ranks() == 1 and ranks("--devices", "2") == 2
    assert ranks("--engine", "dp", "--multihost") == 1


def test_halo_engine_ranks_write_the_same_file(tmp_path, capfd):
    """--engine halo on 2 gloo ranks writes the file one rank writes, which
    is the single engine's; rank 0 alone prints."""
    ev, base = _events_file(tmp_path, "halo", n=700)
    point = [*_POINT, "--device", "cpu", "--steps-per-scan", "1"]
    outputs = {}
    for engine in (["--engine", "single"], ["--engine", "halo"],
                   ["--engine", "halo", "--devices", "2"]):
        assert tcli.main(["--filename", base, *point, *engine]) == 0
        with open(base + "_FARMSOut_batch.txt") as f:
            outputs[" ".join(engine)] = f.read()
        assert capfd.readouterr().out.count("[Benchmark Main]") == 1
    single, one, two = outputs.values()
    assert one == single and two == single
    assert (read_flow_txt(base + "_FARMSOut_batch.txt").r_local > 0).sum() > 100


def test_cuda_requested_without_cuda_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, base = _events_file(tmp_path, "y", n=10)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["--filename", base, "--width", "64", "--height", "64"])
