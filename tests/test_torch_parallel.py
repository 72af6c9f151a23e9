"""Rendering across processes (wave_tracer_tpu_torch.parallel) on the CPU.

Two ranks of a gloo process group, spawned with torch.multiprocessing and
joined through a `file://` rendezvous under the test's tmp_path (so that
parallel test workers never race for a port), render each mode of the
port at 8×8: classical and wave plt_path, plt_bdpt and forward transport
onto a virtual plane. Every draw is keyed by (pixel, sample) or, forward,
by (global lane id, sample), so two ranks must give one rank's film to
summation order: within 1e-5·max. The forward render of 2 ranks × L lanes
is held against 1 rank × 2L (the same chunks of global lane ids).

`render_distributed` at one rank is held against the JAX package's
`render_distributed` on the test harness's eight virtual CPU devices
(the same lanes, its films psum-merged over the mesh), on the same
bridged tables, classical and wave, at the bars of PERF.md §2.

Every join has a deadline: a rank that hangs fails the test instead of
holding the suite.
"""

import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

from test_torch_threads import cap_torch_threads
from wave_tracer_tpu_torch.parallel import launch
from wave_tracer_tpu_torch.parallel.dist import render_distributed
from wave_tracer_tpu_torch.scene.build import BuiltScene, build_scene
from wave_tracer_tpu_torch.scene.procedural import (make_box_scene,
                                                    make_coverage_scene)

cap_torch_threads()

RES = 8
# lanes per rank; a chunk of 2 ranks is 2·L lanes, with padding lanes in
# the last one
LANES = 24
JOIN_S = 150.0


def _box(fsd, integrator="plt_path", spp=2, depth=3):
    scene = make_box_scene(res=RES, spp=spp)
    scene.integrator.type = integrator
    scene.integrator.fsd = fsd
    scene.integrator.max_depth = depth
    return scene


def _coverage():
    scene = make_coverage_scene(RES)
    scene.integrator.max_depth = 3
    return scene


# mode → (scene maker, spp, lanes per rank of the two-rank group, of the
# one-rank render)
CASES = {
    "classical": (lambda: _box(False), 2, LANES, LANES),
    "wave": (lambda: _box(True, spp=1), 1, LANES, LANES),
    "bdpt": (lambda: _box(True, "plt_bdpt", spp=1), 1, LANES, LANES),
    "forward": (_coverage, 2, LANES, 2 * LANES),
}
MODES = {"classical": "ray-dist", "wave": "wave-dist", "bdpt": "bdpt-dist",
         "forward": "forward-dist"}


def _rank_main(rank, world, init, out_dir):
    """One rank: join the group, render every case, save its image."""
    torch.set_num_threads(2)
    assert launch.initialize_distributed(init, world, rank, device="cpu",
                                         timeout_s=60.0)
    try:
        for name, (make, spp, lanes, _) in CASES.items():
            built = build_scene(make(), device="cpu")
            img, st = render_distributed(built, spp=spp,
                                         lanes_per_device=lanes, seed=1,
                                         device="cpu")
            np.save(os.path.join(out_dir, f"{name}_{rank}.npy"), img)
            with open(os.path.join(out_dir, f"{name}_{rank}.json"),
                      "w") as f:
                json.dump(st, f)
    finally:
        launch.shutdown()


def spawn_ranks(fn, world, *args, deadline_s=JOIN_S):
    """Run fn(rank, world, *args) in `world` spawned processes; raise if
    one fails or they are not done within deadline_s (then kill them)."""
    ctx = torch.multiprocessing.start_processes(
        fn, args=(world, *args), nprocs=world, join=False,
        start_method="spawn")
    end = time.monotonic() + deadline_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > end:
                raise TimeoutError(f"ranks not done in {deadline_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    spawn_ranks(_rank_main, 2, f"file://{out / 'rendezvous'}", str(out))
    return out


@pytest.mark.parametrize("mode", list(CASES))
def test_two_ranks_give_one_ranks_film(two_ranks, mode):
    make, spp, _, lanes1 = CASES[mode]
    ref, st = render_distributed(build_scene(make(), device="cpu"), spp=spp,
                                 lanes_per_device=lanes1, seed=1,
                                 device="cpu")
    assert st["mode"] == MODES[mode] and st["processes"] == 1
    assert np.isfinite(ref).all() and np.abs(ref).max() > 0
    for rank in (0, 1):
        img = np.load(two_ranks / f"{mode}_{rank}.npy")
        st2 = json.loads((two_ranks / f"{mode}_{rank}.json").read_text())
        assert st2["mode"] == MODES[mode] and st2["processes"] == 2
        assert st2["paths"] == st["paths"] == RES * RES * spp
        np.testing.assert_allclose(img, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


def _flatten(obj, prefix=""):
    if dataclasses.is_dataclass(obj):
        out = {}
        for f in dataclasses.fields(obj):
            out.update(_flatten(getattr(obj, f.name), f"{prefix}{f.name}."))
        return out
    return {prefix[:-1]: np.asarray(obj)}


@pytest.mark.parametrize("fsd", [False, True])
def test_render_distributed_matches_jax(fsd):
    """One rank against the JAX package's mesh render (8 virtual CPU
    devices), on the JAX bake's tables: classical at its bars (channel
    means within 1%, ≥ 98% of pixels within 1e-3·max(|ref|, mean|ref|)),
    wave at its (means within 2%, Pearson ≥ 0.999, ≥ 90% within
    1e-2·max)."""
    import jax
    from test_render import make_box_scene as jmake_box_scene
    from wave_tracer_tpu.parallel.dist import \
        render_distributed as jrender_distributed
    from wave_tracer_tpu.scene import build_scene as jbuild
    from wave_tracer_tpu_torch.scene.bridge import SPECTRAL_KEYS
    if len(jax.devices()) < 8:
        pytest.skip("needs the harness's 8 virtual CPU devices")
    spp = 1 if fsd else 2
    jscene = jmake_box_scene(res=RES, spp=spp)
    jscene.integrator.fsd = fsd
    jscene.integrator.max_depth = 3
    jb = jbuild(jscene)
    jimg, jst = jrender_distributed(jb, spp=spp, lanes_per_device=LANES,
                                    seed=1)
    arrays = _flatten(jb.data)
    spectral = {k: arrays[f"spectral.{k}"] for k in SPECTRAL_KEYS}
    built = BuiltScene.upload(_box(fsd, spp=spp), arrays, [spectral], "cpu")
    img, st = render_distributed(built, spp=spp, lanes_per_device=LANES,
                                 seed=1, device="cpu")
    assert st["mode"] == jst["mode"] == ("wave-dist" if fsd else "ray-dist")
    assert jst["devices"] == 8 and st["devices"] == 1
    assert img.shape == jimg.shape == (RES, RES, 3)
    assert np.isfinite(img).all() and img.mean() > 0
    np.testing.assert_allclose(img.mean((0, 1)), jimg.mean((0, 1)),
                               rtol=0.02 if fsd else 0.01)
    scale = np.maximum(np.abs(jimg), np.abs(jimg).mean())
    share = (np.abs(img - jimg) <= (1e-2 if fsd else 1e-3) * scale
             ).all(-1).mean()
    if fsd:
        assert np.corrcoef(img.ravel(), jimg.ravel())[0, 1] >= 0.999
        assert share >= 0.90
    else:
        assert share >= 0.98


def test_initialize_distributed(tmp_path):
    """A single process has nothing to coordinate (False, nothing
    started); a group whose peer never arrives raises after its timeout
    instead of hanging."""
    assert launch.initialize_distributed(num_processes=1) is False
    assert launch.initialize_distributed() is False
    assert launch.world() == (0, 1) and launch.is_main_process()
    t0 = time.monotonic()
    with pytest.raises(Exception):
        launch.initialize_distributed(f"file://{tmp_path / 'rdv'}", 2, 0,
                                      device="cpu", timeout_s=2.0)
    assert time.monotonic() - t0 < 60
    assert not torch.distributed.is_initialized()


def _cli_box(tmp_path, fsd=True):
    from wave_tracer_tpu_torch.scene.procedural import box_scene_xml
    p = tmp_path / "box.xml"
    p.write_text(box_scene_xml(RES, 2, 3, fsd))
    return str(p)


def _cli_rank(rank, world, scene, init, out):
    torch.set_num_threads(2)
    from wave_tracer_tpu_torch import cli
    assert cli.main(["render", scene, "--device", "cpu", "--distributed",
                     "--coordinator", init, "--num-processes", str(world),
                     "--process-id", str(rank), "--batch_lanes", "24",
                     "--write-stats", "-o", os.path.join(out, f"r{rank}")
                     ]) == 0


def test_cli_distributed_two_ranks(tmp_path):
    """`render --distributed` in two processes: rank 0 alone writes
    (rank 1's output directory is never made), and its EXR is the
    one-process distributed render's within 1e-5·max and the plain CLI
    render's at the wave bars."""
    from wave_tracer_tpu_torch import cli
    from wave_tracer_tpu_torch.render import output as tout
    scene = _cli_box(tmp_path)
    spawn_ranks(_cli_rank, 2, scene, f"file://{tmp_path / 'rdv'}",
                str(tmp_path))
    assert not (tmp_path / "r1").exists()
    stats = json.loads((tmp_path / "r0" / "perf_stats.json").read_text())
    assert stats[0]["processes"] == 2 and stats[0]["mode"] == "wave-dist"
    for args, tag in ((["--distributed", "--batch_lanes", "48"], "one"),
                      ([], "plain")):
        assert cli.main(["render", scene, "--device", "cpu", "-o",
                         str(tmp_path / tag), *args]) == 0

    def rgb(tag):
        img, names = tout.read_exr(str(tmp_path / tag / "camera.exr"))
        return np.stack([img[..., names.index(c)] for c in "RGB"], -1)

    two, one, plain = rgb("r0"), rgb("one"), rgb("plain")
    np.testing.assert_allclose(two, one, rtol=0,
                               atol=1e-5 * np.abs(one).max())
    assert np.corrcoef(two.ravel(), plain.ravel())[0, 1] >= 0.999
    scale = np.maximum(np.abs(plain), np.abs(plain).mean())
    assert (np.abs(two - plain) <= 1e-2 * scale).all(-1).mean() >= 0.90


def test_cli_distributed_refusals_and_ctrl_c(tmp_path, monkeypatch, capsys):
    """--resume, --checkpoint and --ui are refused with --distributed;
    Ctrl-C aborts a distributed render, says so and writes nothing."""
    import signal
    from wave_tracer_tpu_torch import cli
    from wave_tracer_tpu_torch.parallel import dist as dist_mod
    scene = _cli_box(tmp_path)
    for extra, msg in ((["--resume"], "writes no checkpoint"),
                       (["--checkpoint"], "writes no checkpoint"),
                       (["--ui"], "--ui is refused")):
        with pytest.raises(SystemExit, match=msg):
            cli.main(["render", scene, "--device", "cpu", "--distributed",
                      *extra])

    def interrupted(*a, **k):
        os.kill(os.getpid(), signal.SIGINT)
        time.sleep(5)
        raise AssertionError("Ctrl-C did not abort")

    monkeypatch.setattr(dist_mod, "render_distributed", interrupted)
    out = tmp_path / "o"
    with pytest.raises(KeyboardInterrupt):
        cli.main(["render", scene, "--device", "cpu", "--distributed", "-o",
                  str(out)])
    assert "aborting the distributed render" in capsys.readouterr().out
    assert not list(out.glob("*"))
    assert signal.getsignal(signal.SIGINT) is signal.default_int_handler
