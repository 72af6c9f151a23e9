"""The live render frontend (wave_tracer_tpu_torch.util.ui) and `--ui`.

The port's RenderUI is driven with the calls of tests/test_ui.py beside
the JAX package's and must answer alike: the status JSON, the control
transitions, the 400 for an unknown action, the preview PNG's pixels.
Then the CLI's `--ui 0 --device cpu` render is driven over HTTP (pause,
capture, the preview at the film's size, resume), and Ctrl-C during a
pause the page asked for ends the render, with its completed work and
checkpoint written (the JAX CLI's pause loop never sees its Ctrl-C).
"""

import json
import os
import queue
import signal
import struct
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from test_torch_threads import cap_torch_threads
from wave_tracer_tpu.util.ui import RenderUI as JRenderUI
from wave_tracer_tpu_torch import cli
from wave_tracer_tpu_torch.render.output import decode_png
from wave_tracer_tpu_torch.scene.procedural import box_scene_xml
from wave_tracer_tpu_torch.util import ui as ui_mod

cap_torch_threads()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=5) as r:
        return r.status, r.read()


def _post(port, path):
    """The status code of a POST (4xx answers too)."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 method="POST", data=b"")
    try:
        with urllib.request.urlopen(req, timeout=5) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def _png_size(png):
    assert png[:8] == b"\x89PNG\r\n\x1a\n" and png[12:16] == b"IHDR"
    return struct.unpack(">II", png[16:24])


def _drive(ui_cls):
    """tests/test_ui.py's calls on one RenderUI; returns what it answered."""
    ui = ui_cls()
    port = ui.serve(0)
    seen = {}
    try:
        code, body = _get(port, "/")
        seen["page"] = code == 200 and b"live render" in body
        ui.set_scene_info({"triangles": 42})
        ui.set_sensor("camera")
        ui.progress(3, 16, paths_per_sec=1234.0)
        seen["status"] = json.loads(_get(port, "/status")[1])
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(port, "/preview.png")           # no capture yet
        seen["preview_before"] = e.value.code
        assert _post(port, "/pause") == 200
        released = []
        t = threading.Thread(target=lambda: released.append(ui.interrupt()))
        t.start()
        time.sleep(0.15)
        seen["blocks_while_paused"] = t.is_alive()
        seen["paused"] = json.loads(_get(port, "/status")[1])["state"]
        assert _post(port, "/resume") == 200
        t.join(timeout=5)
        seen["released"] = (not t.is_alive(), released)
        assert _post(port, "/capture") == 200
        seen["capture"] = (ui.interrupt(), ui.interrupt())
        img = np.random.default_rng(0).random((6, 10, 3)).astype(np.float32)
        ui.on_capture(img, 4)
        png = _get(port, "/preview.png")[1]
        # the same pixels (the JAX package encodes with PIL)
        seen["png"] = (_png_size(png), decode_png(png).tobytes())
        seen["serial"] = json.loads(_get(port, "/status")[1])["new_capture"]
        assert _post(port, "/terminate") == 200
        seen["terminate"] = (ui.interrupt(), _post(port, "/resume"))
        seen["bad_action"] = _post(port, "/nonsense")
    finally:
        ui.shutdown()
    return seen


def test_render_ui_answers_as_jax():
    port_ui, jax_ui = _drive(ui_mod.RenderUI), _drive(JRenderUI)
    assert port_ui == jax_ui
    assert port_ui["status"] == {
        "state": "running", "spp": 16, "spp_done": 3,
        "paths_per_sec": 1234.0, "sensor": "camera",
        "scene": {"triangles": 42}, "new_capture": 0}
    assert port_ui["blocks_while_paused"] and port_ui["paused"] == "paused"
    assert port_ui["released"] == (True, [None])
    assert port_ui["capture"] == ("capture", None)
    assert port_ui["png"][0] == (10, 6) and port_ui["serial"] == 1
    assert port_ui["preview_before"] == 404 and port_ui["bad_action"] == 400
    assert port_ui["terminate"] == ("terminate", 400)


def test_terminate_ends_a_pause():
    ui = ui_mod.RenderUI()
    ui._control("pause")
    out = []
    t = threading.Thread(target=lambda: out.append(ui.interrupt()))
    t.start()
    time.sleep(0.15)
    assert t.is_alive()
    ui.terminate()
    t.join(timeout=5)
    assert out == ["terminate"]


def _cli_with_ui(tmp_path, monkeypatch, helper, spp=8):
    """Run the CLI's `--ui 0` render of the wave box in this thread while
    helper(port) drives the page from another; returns (rc, outputs)."""
    p = tmp_path / "box.xml"
    p.write_text(box_scene_xml(8, spp, 3, True))
    ports = queue.Queue()
    serve = ui_mod.RenderUI.serve

    def recording_serve(self, port=0, host="127.0.0.1"):
        bound = serve(self, port, host)
        ports.put(bound)
        return bound

    monkeypatch.setattr(ui_mod.RenderUI, "serve", recording_serve)
    errors = []

    def run_helper():
        try:
            helper(ports.get(timeout=60))
        except BaseException as e:          # reported in the main thread
            errors.append(e)

    th = threading.Thread(target=run_helper)
    th.start()
    out = tmp_path / "o"
    try:
        rc = cli.main(["render", str(p), "--device", "cpu", "--ui", "0",
                       "-o", str(out), "--write-stats"])
    finally:
        th.join(timeout=60)
    assert not th.is_alive() and not errors, errors
    return rc, out


def _wait(cond, what, timeout=60.0):
    end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > end:
            raise TimeoutError(what)
        time.sleep(0.05)


def test_cli_ui_render_over_http(tmp_path, monkeypatch):
    """--ui 0: pause, capture while paused (the preview is the film's
    size), the status (scene info, progress, paused), resume; the render
    then completes and writes its outputs."""
    seen = {}

    def helper(port):
        assert _post(port, "/pause") == 200
        assert _post(port, "/capture") == 200

        def preview():
            try:
                seen["png"] = _get(port, "/preview.png")[1]
                return True
            except urllib.error.HTTPError:
                return False
        _wait(preview, "no preview")
        seen["status"] = json.loads(_get(port, "/status")[1])
        assert _post(port, "/resume") == 200

    rc, out = _cli_with_ui(tmp_path, monkeypatch, helper)
    assert rc == 0
    assert _png_size(seen["png"]) == (8, 8)
    st = seen["status"]
    assert st["state"] == "paused" and st["spp"] == 8
    assert 1 <= st["spp_done"] < 8 and st["new_capture"] == 1
    assert st["scene"]["triangles"] > 0 and st["sensor"] == "camera"
    for f in ("camera.exr", "camera.png", "camera_capture.exr",
              "perf_stats.json"):
        assert (out / f).is_file(), f
    stats = json.loads((out / "perf_stats.json").read_text())
    assert not stats[0]["interrupted"] and stats[0]["spp_done"] == 8


def test_ctrl_c_ends_a_ui_pause(tmp_path, monkeypatch, capsys):
    """Ctrl-C while the page holds the render paused ends the render: the
    completed work and a resumable checkpoint are written."""

    def helper(port):
        assert _post(port, "/pause") == 200
        _wait(lambda: json.loads(_get(port, "/status")[1])["spp_done"] >= 1,
              "the render never reached its first poll")
        time.sleep(0.2)                 # blocked in the pause by now
        os.kill(os.getpid(), signal.SIGINT)

    rc, out = _cli_with_ui(tmp_path, monkeypatch, helper)
    assert rc == 0
    stats = json.loads((out / "perf_stats.json").read_text())
    assert stats[0]["interrupted"] and stats[0]["spp_done"] < 8
    assert (out / "camera.ckpt.npz").is_file()
    assert (out / "camera.exr").is_file()
    assert "interrupted at" in capsys.readouterr().out
