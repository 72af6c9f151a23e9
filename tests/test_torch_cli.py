"""Port parity for image output, checkpoints, masks, the renderer's
interrupt / resume surface and the command line, against the JAX package.

* EXR: the port's files equal the JAX package's byte for byte (half and
  float channels, ZIP and no compression), and each reads the other's;
* PNG: the port's encoder and decoder against PIL (every colour type and
  filter the decoder reads);
* checkpoints: written by either package, loaded by the other;
* `render_mask` equals the JAX mask (the same Sobol jitter, all-pairs
  traces);
* interrupt and resume (tests/test_util.py's interrupt cases, on the pool,
  the batched renderer, plt_bdpt and forward rendering): a render that
  terminates and resumes from `last_film` / `last_spp_done` equals the
  same chunks rendered without a stop, bit for bit, and the one-chunk
  render within rtol 1e-5 (splat order);
* `cli.main(["render", xml, "--device", "cpu", ...])` writes its files,
  and its EXR agrees with the JAX CLI's EXR of the same file under PERF.md
  §2's classical bars (a point-lit box, so that the port's soup-order bake
  and the JAX BVH-order bake draw the same lights)."""

import io
import json
import os
import signal
import socket
import struct
import threading
import zlib

import numpy as np
import pytest
import torch

from test_torch_threads import cap_torch_threads
from wave_tracer_tpu import cli as jcli
from wave_tracer_tpu.render import checkpoint as jckpt
from wave_tracer_tpu.render import mask as jmask
from wave_tracer_tpu.render import output as jout
from wave_tracer_tpu.scene import build_scene as jbuild
from wave_tracer_tpu.scene import xml as jxml
from wave_tracer_tpu.sensor import film as jfilm
from wave_tracer_tpu.util import tev as jtev
from wave_tracer_tpu_torch import cli
from wave_tracer_tpu_torch.render import checkpoint as tckpt
from wave_tracer_tpu_torch.render import mask as tmask
from wave_tracer_tpu_torch.render import output as tout
from wave_tracer_tpu_torch.render import render_scene
from wave_tracer_tpu_torch.scene import build_scene
from wave_tracer_tpu_torch.scene import xml as txml
from wave_tracer_tpu_torch.scene.procedural import (box_scene_xml,
                                                    make_box_scene,
                                                    make_coverage_scene)
from wave_tracer_tpu_torch.sensor import film as tfilm
from wave_tracer_tpu_torch.util import stats as tstats
from wave_tracer_tpu_torch.util import tev as ttev

cap_torch_threads()


# ---------------------------------------------------------------------------
# EXR and PNG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("half", [True, False])
@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("C", [1, 3, 4, 5])
def test_exr_byte_compatible_with_jax(tmp_path, half, compress, C):
    rng = np.random.default_rng(C)
    img = rng.uniform(0, 10, (33, 47, C)).astype(np.float32)
    img[0, 0, 0] = 1e6                     # clamped to the half range
    meta = {"renderer": "test", "spp": "4"}
    a, b = str(tmp_path / "port.exr"), str(tmp_path / "jax.exr")
    tout.write_exr(a, img, half=half, compress=compress, metadata=meta)
    jout.write_exr(b, img, half=half, compress=compress, metadata=meta)
    assert open(a, "rb").read() == open(b, "rb").read()
    for path in (a, b):
        x, xn = tout.read_exr(path)
        y, yn = jout.read_exr(path)
        assert xn == yn
        np.testing.assert_array_equal(x, y)
    back, names = tout.read_exr(a)
    if C == 3:
        assert names == ["B", "G", "R"]
        back = np.stack([back[..., names.index(c)] for c in "RGB"], -1)
        if half:
            np.testing.assert_allclose(back[1:], img[1:], rtol=2e-3,
                                       atol=2e-2)
        else:
            np.testing.assert_array_equal(back, img)


def test_exr_gray_float_roundtrip(tmp_path):
    img = np.linspace(0, 1, 16 * 16).reshape(16, 16).astype(np.float32)
    p = str(tmp_path / "g.exr")
    tout.write_exr(p, img, half=False, compress=False)
    out, names = jout.read_exr(p)
    assert names == ["Y"]
    np.testing.assert_array_equal(out[..., 0], img)


@pytest.mark.parametrize("C", [1, 2, 3, 4])
def test_png_encoder_against_pil(tmp_path, C):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(C)
    img = rng.uniform(-0.1, 1.1, (13, 21, C))
    data = tout.encode_png(img)
    back = np.asarray(Image.open(io.BytesIO(data)))
    want = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(back.reshape(want.shape), want)
    tout.write_png(str(tmp_path / "a.png"), img)
    assert open(tmp_path / "a.png", "rb").read() == data
    np.testing.assert_array_equal(tout.decode_png(data), want)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P", "PA"])
def test_png_decoder_against_pil(tmp_path, mode):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(len(mode))
    rgba = np.cumsum(rng.integers(0, 40, (31, 17, 4)), axis=1) % 256
    img = Image.fromarray(rgba.astype(np.uint8), "RGBA")
    if mode in ("P", "PA"):
        img = img.convert("RGB").convert("P", palette=Image.ADAPTIVE)
        if mode == "PA":
            img.info["transparency"] = bytes(range(0, 256, 3))[:200]
    else:
        img = img.convert(mode)
    p = tmp_path / "b.png"
    img.save(p, **({"transparency": img.info["transparency"]}
                   if mode == "PA" else {}))
    ours = tout.read_png(str(p))
    ref = Image.open(p)
    ref = ref.convert("RGBA" if mode == "PA" else
                      "RGB" if mode == "P" else mode)
    np.testing.assert_array_equal(ours.reshape(np.asarray(ref).shape),
                                  np.asarray(ref))


def _filtered_png(arr, filters):
    """An 8-bit RGB PNG of arr (H, W, 3) uint8, row y filtered with
    filters[y] (0 none, 1 sub, 2 up, 3 average, 4 Paeth)."""
    H, W, C = arr.shape
    raw = arr.reshape(H, W * C).astype(np.int64)
    rows = []
    for y in range(H):
        cur = raw[y]
        up = raw[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(C, np.int64), cur[:-C]])
        ul = np.concatenate([np.zeros(C, np.int64), up[:-C]])
        ft = filters[y]
        if ft == 0:
            pred = np.zeros_like(cur)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = up
        elif ft == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        rows.append(bytes([ft]) + ((cur - pred) % 256).astype(
            np.uint8).tobytes())

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    return (tout.PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


def test_png_decoder_filters_and_refusals():
    rng = np.random.default_rng(9)
    arr = rng.integers(0, 256, (10, 9, 3)).astype(np.uint8)
    data = _filtered_png(arr, [0, 1, 2, 3, 4, 4, 3, 2, 1, 0])
    np.testing.assert_array_equal(tout.decode_png(data), arr)
    Image = pytest.importorskip("PIL.Image")
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(data))), arr)
    interlaced = bytearray(data)
    interlaced[8 + 8 + 12] = 1              # IHDR's interlace byte
    with pytest.raises(ValueError, match="interlace 1"):
        tout.decode_png(bytes(interlaced))
    with pytest.raises(ValueError, match="not a PNG"):
        tout.decode_png(b"GIF89a" + bytes(20))


# ---------------------------------------------------------------------------
# checkpoints, stats, tev
# ---------------------------------------------------------------------------

def test_checkpoints_load_across_packages(tmp_path):
    rng = np.random.default_rng(0)
    value = rng.uniform(0, 1, (4, 8, 3)).astype(np.float32)
    weight = rng.uniform(0, 1, (4, 8)).astype(np.float32)
    direct = rng.uniform(0, 1, (4, 8, 3)).astype(np.float32)
    jf = jfilm.make_film(8, 4, 3).replace(value=value, weight=weight,
                                          direct=direct)
    tf = tfilm.Film(value=torch.as_tensor(value),
                    weight=torch.as_tensor(weight),
                    direct=torch.as_tensor(direct),
                    rfilter_sigma=jf.rfilter_sigma, radius=jf.radius)
    a, b = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tckpt.save_checkpoint(a, tf, 7, 42, "cam")
    jckpt.save_checkpoint(b, jf, 7, 42, "cam")
    za, zb = np.load(a), np.load(b)
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    for path in (a, b):
        f1, spp1, seed1, sid1 = tckpt.load_checkpoint(path)
        f2, spp2, seed2, sid2 = jckpt.load_checkpoint(path)
        assert (spp1, seed1, sid1) == (spp2, seed2, sid2) == (7, 42, "cam")
        for name in ("value", "weight", "direct"):
            np.testing.assert_array_equal(getattr(f1, name).numpy(),
                                          np.asarray(getattr(f2, name)))
        assert (f1.rfilter_sigma, f1.radius) == (f2.rfilter_sigma,
                                                 f2.radius)
    np.savez(str(tmp_path / "v2.npz"), version=2)
    with pytest.raises(ValueError, match="version"):
        tckpt.load_checkpoint(str(tmp_path / "v2.npz"))


def test_stats_registry(tmp_path):
    r = tstats.Registry()
    r.counter("rays").add(10)
    r.counter("rays").add(5)
    r.histogram("depth").add(4)
    r.histogram("depth").add_count(30, 2)
    r.event_counter("casts").add("hit", 3)
    with r.timing("trace"):
        pass
    rs = r.running("x")
    for x in [1.0, 2.0, 3.0, 4.0]:
        rs.add(x)
    rep = r.report()
    assert rep["rays"] == 15 and sum(rep["depth"]) == 3
    assert rep["depth"][-1] == 2 and rep["casts"]["hit"] == 3
    assert rep["trace"]["count"] == 1
    np.testing.assert_allclose(rep["x"]["std"], np.std([1, 2, 3, 4], ddof=1))
    r.write_json(str(tmp_path / "s.json"))
    assert json.load(open(tmp_path / "s.json"))["rays"] == 15
    lines = []
    r.print_table(lines.append)
    assert any(line.startswith("rays") for line in lines)
    r.reset()
    assert r.report() == {}


def _tev_bytes(mod, img):
    """What mod.TevPreview sends for one image, read by a local server."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    got = []

    def serve():
        conn, _ = srv.accept()
        with conn:
            while True:
                b = conn.recv(65536)
                if not b:
                    break
                got.append(b)
    th = threading.Thread(target=serve)
    th.start()
    pv = mod.TevPreview(f"127.0.0.1:{srv.getsockname()[1]}", "cam", 5, 3)
    pv.update(img)
    pv.client.close_image("cam")
    pv.client.close()
    th.join(10)
    srv.close()
    return b"".join(got)


def test_tev_packets_match_jax():
    img = np.random.default_rng(1).uniform(0, 1, (3, 5, 1))
    data = _tev_bytes(ttev, img)
    assert data == _tev_bytes(jtev, img)
    (n,) = struct.unpack("<I", data[:4])
    assert data[4] == ttev.OP_CREATE and n < len(data)


# ---------------------------------------------------------------------------
# the mask, interrupts and resume
# ---------------------------------------------------------------------------

def _box_file(d, res, spp, depth=3, fsd=False, emitter="point", **kw):
    p = d / "box.xml"
    # a brighter lamp than the benchmark's, so that half-float EXRs (the
    # JAX CLI's) keep the image
    p.write_text(box_scene_xml(res, spp, depth, fsd, emitter, **kw).replace(
        'value="5e-13"', 'value="5e-7"'))
    return str(p)


def test_render_mask_matches_jax(tmp_path):
    p = _box_file(tmp_path, 16, 2)
    jsc = jxml.load_scene_xml(p)
    jalpha = jmask.render_mask(jbuild(jsc), jsc.sensors[0], seed=3,
                               batch=100)
    tsc = txml.load_scene_xml(p)
    talpha = tmask.render_mask(build_scene(tsc, device="cpu"),
                               tsc.sensors[0], seed=3, batch=100)
    assert talpha.shape == (16, 16) and talpha.dtype == np.float32
    assert 0 < talpha.mean() < 1
    np.testing.assert_array_equal(talpha, jalpha)


def _cells():
    """name → (built scene, render kwargs) of each renderer branch."""
    box = make_box_scene(res=8, spp=8)
    box.integrator.max_depth = 4
    classical = make_box_scene(res=8, spp=8)
    classical.integrator.fsd = False
    bdpt = make_box_scene(res=8, spp=8)
    bdpt.integrator.type, bdpt.integrator.max_depth = "plt_bdpt", 3
    return {
        "pool": (box, dict(pool_lanes=512)),
        "batched": (classical, dict(pool_lanes=256, compact=False)),
        "bdpt": (bdpt, dict(pool_lanes=256)),
        "forward": (make_coverage_scene(8), dict(spp=4, pool_lanes=64)),
    }


@pytest.mark.parametrize("cell", ["pool", "batched", "bdpt", "forward"])
def test_terminate_and_resume(cell):
    scene, kw = _cells()[cell]
    built = build_scene(scene, device="cpu")
    spp = kw.pop("spp", 8)
    common = dict(spp=spp, seed=3, device="cpu", **kw)
    full, st0 = render_scene(built, **common)
    assert not st0["interrupted"]
    chunked, _ = render_scene(built, interrupt=lambda: None, **common)
    polls = {"n": 0}

    def interrupt():
        polls["n"] += 1
        return "terminate" if polls["n"] >= 2 else None

    part, st1, rend = render_scene(built, interrupt=interrupt,
                                   return_renderer=True, **common)
    assert st1["interrupted"] and 0 < st1["spp_done"] < spp
    assert rend.last_spp_done == st1["spp_done"]
    resumed, st2, rend2 = render_scene(
        built, interrupt=lambda: None, init_film=rend.last_film,
        spp_start=rend.last_spp_done, return_renderer=True, **common)
    assert not st2["interrupted"] and st2["spp_done"] == spp
    np.testing.assert_array_equal(resumed, chunked)
    np.testing.assert_allclose(resumed, full, rtol=1e-5, atol=1e-12)
    # resuming a finished render traces nothing and develops its film
    again, st3 = render_scene(built, init_film=rend2.last_film,
                              spp_start=rend2.last_spp_done, **common)
    assert st3["paths"] == 0 and not st3["interrupted"]
    np.testing.assert_array_equal(again, resumed)


def test_capture_intermediate():
    built = build_scene(make_box_scene(res=8, spp=4), device="cpu")
    captures = []
    img, st = render_scene(built, spp=4, seed=1, device="cpu",
                           pool_lanes=512, interrupt=lambda: "capture",
                           on_capture=lambda im, n: captures.append(
                               (im.copy(), n)))
    assert not st["interrupted"] and len(captures) == 4
    assert [n for _, n in captures] == [1, 2, 3, 4]
    assert all(np.isfinite(im).all() for im, _ in captures)
    np.testing.assert_array_equal(captures[-1][0], img)


def test_render_records_device_counters():
    reg = tstats.registry
    before = reg.counter("integrator/rays_cast").value
    built = build_scene(make_box_scene(res=8, spp=2), device="cpu")
    _, st = render_scene(built, device="cpu")
    after = reg.counter("integrator/rays_cast").value
    assert after - before == st["device_counters"]["rays_cast"] > 0


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def _rgb(path):
    img, names = tout.read_exr(path)
    return np.stack([img[..., names.index(c)] for c in "RGB"], -1)


def test_cli_render_matches_jax_cli(tmp_path):
    p = _box_file(tmp_path, 16, 4)
    out = tmp_path / "port"
    rc = cli.main(["render", p, "--device", "cpu", "-D", "res=8,spp=2",
                   "-o", str(out), "--write-stats", "--mask",
                   "--checkpoint"])
    assert rc == 0
    for f in ("camera.exr", "camera.png", "camera_mask.png",
              "perf_stats.json", "camera.ckpt.npz"):
        assert (out / f).is_file(), f
    (st,) = json.load(open(out / "perf_stats.json"))
    assert st["mode"] == "ray-compact" and st["paths"] == 128
    assert not st["interrupted"]
    img = _rgb(str(out / "camera.exr"))
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()
    # the EXR is the developed render (float32, lossless)
    sc = txml.load_scene_xml(p, {"res": "8", "spp": "2"})
    built = build_scene(sc, device="cpu")
    ref, _ = render_scene(built, device="cpu", interrupt=lambda: None)
    M = sc.sensors[0].response.develop_matrix()
    np.testing.assert_array_equal(img, (ref @ M.T).astype(np.float32))
    png = tout.read_png(str(out / "camera.png"))
    assert png.shape == (8, 8, 3) and png.max() > 200
    alpha = tout.read_png(str(out / "camera_mask.png"))[..., 0]
    jsc = jxml.load_scene_xml(p, {"res": "8", "spp": "2"})
    jalpha = jmask.render_mask(jbuild(jsc), jsc.sensors[0])
    np.testing.assert_array_equal(
        alpha, np.clip(jalpha * 255.0 + 0.5, 0, 255).astype(np.uint8))
    film, spp_done, seed, sid = tckpt.load_checkpoint(
        str(out / "camera.ckpt.npz"))
    assert (spp_done, seed, sid) == (2, 0, "camera")
    # the JAX CLI on the same file
    jout_dir = tmp_path / "jax"
    assert jcli.main(["render", p, "-D", "res=8,spp=2", "-o",
                      str(jout_dir)]) == 0
    jimg = _rgb(str(jout_dir / "camera.exr"))
    mean, mref = img.mean((0, 1)), jimg.mean((0, 1))
    assert (np.abs(mean - mref) <= 0.01 * np.abs(mref)).all()
    scale = np.maximum(np.abs(jimg), np.abs(jimg).mean())
    assert (np.abs(img - jimg) <= 1e-3 * scale).all(-1).mean() >= 0.98


def test_cli_sigint_checkpoint_and_resume(tmp_path, monkeypatch):
    """The first Ctrl-C ends the render after its chunk and writes the
    image and a checkpoint; --resume finishes it, equal to a render that
    was never stopped."""
    p = _box_file(tmp_path, 8, 8)
    whole = tmp_path / "whole"
    assert cli.main(["render", p, "--device", "cpu", "-o", str(whole)]) == 0
    import wave_tracer_tpu_torch.render as render_pkg
    real = render_pkg.render_scene

    def ctrl_c_once(*a, progress=None, **kw):
        def progress_then_sigint(done, total):
            progress(done, total)
            if done == 3:
                os.kill(os.getpid(), signal.SIGINT)
        return real(*a, progress=progress_then_sigint, **kw)

    monkeypatch.setattr(render_pkg, "render_scene", ctrl_c_once)
    handler = signal.getsignal(signal.SIGINT)
    out = tmp_path / "out"
    assert cli.main(["render", p, "--device", "cpu", "-o", str(out),
                     "--write-stats"]) == 0
    monkeypatch.setattr(render_pkg, "render_scene", real)
    (st,) = json.load(open(out / "perf_stats.json"))
    assert st["interrupted"] and st["spp_done"] == 3
    film, done, _, _ = tckpt.load_checkpoint(str(out / "camera.ckpt.npz"))
    assert done == 3
    assert signal.getsignal(signal.SIGINT) is handler
    assert cli.main(["render", p, "--device", "cpu", "-o", str(out),
                     "--resume", "--write-stats"]) == 0
    (st,) = json.load(open(out / "perf_stats.json"))
    assert not st["interrupted"] and st["paths"] == 5 * 64
    np.testing.assert_array_equal(_rgb(str(out / "camera.exr")),
                                  _rgb(str(whole / "camera.exr")))


def test_cli_polarimetric_sensor_writes_stokes(tmp_path):
    p = tmp_path / "pol.xml"
    p.write_text(box_scene_xml(8, 2, 3, False).replace(
        '<sensor type="perspective" id="camera">',
        '<sensor type="perspective" id="camera" polarimetric="true">'))
    out = tmp_path / "out"
    assert cli.main(["render", str(p), "--device", "cpu", "-o",
                     str(out), "--ray-tracing"]) == 0
    sc = txml.load_scene_xml(str(p))
    sc.integrator.ray_trace_only = True
    assert sc.sensors[0].polarimetric
    img, st = render_scene(build_scene(sc, device="cpu"), device="cpu",
                           interrupt=lambda: None)
    assert img.shape == (8, 8, 12) and st["mode"] == "ray-compact"
    M = sc.sensors[0].response.develop_matrix()
    st4 = img.reshape(8, 8, 3, 4)
    for ci, comp in enumerate("IQUV"):
        np.testing.assert_array_equal(
            _rgb(str(out / f"camera_{comp}.exr")),
            (st4[..., ci] @ M.T).astype(np.float32), err_msg=comp)
    np.testing.assert_array_equal(_rgb(str(out / "camera.exr")),
                                  _rgb(str(out / "camera_I.exr")))


def test_cli_refusals(tmp_path, monkeypatch, capsys):
    p = _box_file(tmp_path, 4, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["render", p, "-o", str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()
    with pytest.raises(SystemExit, match="writes no checkpoint"):
        cli.main(["render", p, "--device", "cpu", "--distributed",
                  "--resume"])
    with pytest.raises(SystemExit, match="bad define"):
        cli.main(["render", p, "--device", "cpu", "-D", "res"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_scene(build_scene(txml.load_scene_xml(p), device="cpu"))
    assert cli.main(["version"]) == 0
    assert capsys.readouterr().out.strip() == "wave_tracer_tpu_torch 0.1.0"
    assert cli.parse_defines(["a=1,b=x", "c= 2 "]) == \
        jcli.parse_defines(["a=1,b=x", "c= 2 "]) == \
        {"a": "1", "b": "x", "c": "2"}


def test_cli_options_take_effect(tmp_path):
    """--spp, --seed, --batch_lanes and --tev reach the render; a tev
    viewer that is not there costs a message, not the render; --mesh_scale
    scales PLY and OBJ shapes as the JAX loader does."""
    p = _box_file(tmp_path, 8, 4)
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    got = []

    def serve():
        conn, _ = srv.accept()
        with conn:
            got.append(conn.recv(1 << 20))
    th = threading.Thread(target=serve)
    th.start()
    out = tmp_path / "o"
    assert cli.main(["render", p, "--device", "cpu", "-o", str(out),
                     "--spp", "3", "--seed", "5", "--batch_lanes", "40",
                     "--write-stats", "--checkpoint", "--tev",
                     f"127.0.0.1:{srv.getsockname()[1]}"]) == 0
    th.join(10)
    srv.close()
    assert not th.is_alive() and got and got[0][4] == ttev.OP_CREATE
    (st,) = json.load(open(out / "perf_stats.json"))
    assert st["paths"] == 3 * 64 and st["pool_lanes"] == 40
    assert tckpt.load_checkpoint(str(out / "camera.ckpt.npz"))[1:3] == (3, 5)
    assert cli.main(["render", p, "--device", "cpu", "-o", str(out),
                     "--spp", "1", "--tev", "127.0.0.1:1"]) == 0
    ply = tmp_path / "m.ply"
    ply.write_text("ply\nformat ascii 1.0\nelement vertex 3\nproperty float x"
                   "\nproperty float y\nproperty float z\nelement face 1\n"
                   "property list uchar int vertex_indices\nend_header\n"
                   "0 0 0\n1 0 0\n0 1 0.5\n3 0 1 2\n")
    (tmp_path / "m.obj").write_text("v 0 0 0\nv 1 0 0\nv 0 1 0.5\nf 1 2 3\n")
    for name, extra in (("ply", ""), ("obj", '<float name="scale" '
                                              'value="3"/>')):
        scene = tmp_path / f"{name}.xml"
        scene.write_text(open(p).read().replace(
            "</scene>", f'<shape type="{name}"><path value="m.{name}"/>'
            f'{extra}<ref id="white"/></shape></scene>'))
        soup = txml.load_scene_xml(str(scene), mesh_scale=2.0).shapes[-1].soup
        np.testing.assert_array_equal(
            soup.positions[0].max(0),
            [2.0, 2.0, 1.0] if name == "ply" else [3.0, 3.0, 1.5])
    jsoup = jxml.load_scene_xml(str(tmp_path / "ply.xml"),
                                mesh_scale=2.0).shapes[-1].soup
    assert soup.positions.shape == jsoup.positions.shape
    np.testing.assert_array_equal(
        txml.load_scene_xml(str(tmp_path / "ply.xml"),
                            mesh_scale=2.0).shapes[-1].soup.positions,
        jsoup.positions)


def test_cli_passes_on_capture(tmp_path, monkeypatch):
    """A "capture" from the interrupt callback writes the intermediate
    image as <sensor>_capture.exr (the last one: the finished image)."""
    p = _box_file(tmp_path, 8, 2)
    import wave_tracer_tpu_torch.render as render_pkg
    real = render_pkg.render_scene
    monkeypatch.setattr(render_pkg, "render_scene", lambda *a, **kw: real(
        *a, **dict(kw, interrupt=lambda: "capture")))
    out = tmp_path / "o"
    assert cli.main(["render", p, "--device", "cpu", "-o", str(out)]) == 0
    np.testing.assert_array_equal(_rgb(str(out / "camera_capture.exr")),
                                  _rgb(str(out / "camera.exr")))
