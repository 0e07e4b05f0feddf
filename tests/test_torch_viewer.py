"""The port's browser viewer (``ray_tracer_2_tpu_torch/viewer/``) on the
CPU, ``Engine(device="cpu")`` at the reference's sizes: the reference's
``tests/test_viewer.py`` (input routing, state JSON), ``test_viewer_gizmo.py``
(pick/drag: display-normalized coordinates, origin top-left, as the
streamed frame is the framebuffer flipped vertically) and
``test_viewer_ws.py`` (the WebSocket input channel against a live server),
each case under its own name; then what the port serves in place of JPEG:
``/frame.png`` and the ``/stream.mpng`` push stream carry PNG (checked by
signature and decoded against the framebuffer), and the server runs and
answers in a fresh interpreter where neither JAX nor PIL can be imported.
"""
import base64
import json
import os
import socket
import struct
import subprocess
import sys
import threading
import time
import urllib.request
import zlib
from pathlib import Path

import numpy as np
import pytest

from ray_tracer_2_tpu_torch.engine import Engine
from ray_tracer_2_tpu_torch.engine.export import framebuffer_to_srgb
from ray_tracer_2_tpu_torch.scene.scenes import SceneName
from ray_tracer_2_tpu_torch.viewer.server import ViewerServer

ROOT = Path(__file__).resolve().parents[1]
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _engine(width, height, scene=SceneName.METAL):
    eng = Engine(width=width, height=height, initial_scene=scene,
                 block_on_initial_scene=True, device="cpu")
    eng.update(dt=0.01)
    return eng


@pytest.fixture(scope="module")
def viewer():
    eng = _engine(48, 32)
    yield ViewerServer(eng)
    eng.scene_manager.shutdown()


# ---- tests/test_viewer.py -----------------------------------------------
def test_state_shape(viewer):
    s = viewer.state()
    assert s["scene"] == "Metal"
    assert len(s["scenes"]) == 7
    assert s["params"]["bounces"] == 5
    assert s["camera"] is not None and len(s["camera"]["pos"]) == 3


def test_keyboard_moves_camera(viewer):
    eng = viewer.engine
    pos0 = eng.scene_manager.scene.camera.transform.pos.copy()
    viewer.handle_input({"keys": {"w": True}})
    eng.update(dt=0.1)
    viewer.handle_input({"keys": {"w": False}})
    assert not np.allclose(pos0, eng.scene_manager.scene.camera.transform.pos)
    assert eng.params.frames <= 0       # movement reset accumulation


def test_param_set_resets_accumulation(viewer):
    eng = viewer.engine
    eng.update(dt=0.01)
    eng.update(dt=0.01)
    viewer.handle_input({"set": {"bounces": 3}})
    assert eng.params.bounces == 3 and eng.params.frames == -1
    viewer.handle_input({"set": {"skybox": False}})
    assert not eng.params.skybox


def test_entity_edit_via_input(viewer):
    eng = viewer.engine
    viewer.handle_input({"edit_entity": {
        "kind": "sphere", "index": 0, "centre": [9.0, 9.0, 9.0]}})
    np.testing.assert_allclose(
        eng.scene_manager.scene.scene.sphere_pos[0].numpy(), [9, 9, 9])
    assert eng.params.frames == -1


def test_stats_refresh_under_continuous_async_dispatch(viewer):
    """A render loop that always has a frame in flight still sees stats
    advance (the numbers of the last settled frame)."""
    eng = viewer.engine
    frames_seen = []
    for _ in range(6):
        eng.update(dt=0.01)
        frames_seen.append(eng.stats.frame)
    assert max(frames_seen) >= frames_seen[0] + 4, frames_seen
    assert eng.stats.mrays_per_s > 0.0


def test_bad_input_is_harmless(viewer):
    viewer.handle_input({"set": {"nonexistent": 1}})
    viewer.handle_input({"edit_entity": {"kind": "sphere", "index": 999,
                                         "radius": 1.0}})
    viewer.handle_input({"keys": {"zz": True}})


# ---- tests/test_viewer_gizmo.py -----------------------------------------
@pytest.fixture(scope="module")
def gizmo():
    eng = _engine(64, 36)
    yield ViewerServer(eng)
    eng.scene_manager.shutdown()


def project(viewer, p):
    """Invert the camera model: world point -> display-normalized (u, v)."""
    scene = viewer.engine.scene_manager.scene
    cu = scene.camera.to_uniform()
    m = np.asarray(cu.cam_to_world, np.float64)
    pc = m[:3, :3].T @ (np.asarray(p, np.float64) - m[:3, 3])
    q = pc * (cu.view_params[2] / pc[2])
    u = q[0] / cu.view_params[0] + 0.5
    v_fb = q[1] / cu.view_params[1] + 0.5
    return u, 1.0 - v_fb     # display v flips the framebuffer row axis


def _sphere_pos(viewer):
    return viewer.engine.scene_manager.scene.scene.sphere_pos.numpy().copy()


def test_pick_selects_sphere_under_cursor(gizmo):
    scene = gizmo.engine.scene_manager.scene
    pos = _sphere_pos(gizmo)
    u, v = project(gizmo, pos[0])
    gizmo.handle_input({"pick": [u, v]})
    assert gizmo._selected is not None
    assert gizmo._selected["kind"] == "sphere"
    sel = gizmo._selected["index"]
    eye = np.asarray(scene.camera.to_uniform().cam_to_world,
                     np.float64)[:3, 3]
    # the selected sphere is sphere 0 or one in front of it
    assert np.linalg.norm(pos[sel] - eye) <= \
        np.linalg.norm(pos[0] - eye) + 1e-6


def test_pick_miss_clears_selection(gizmo):
    gizmo.handle_input({"pick": [0.0, 0.0]})   # top-left sky corner
    assert gizmo._selected is None


def test_drag_moves_sphere_on_camera_plane(gizmo):
    scene = gizmo.engine.scene_manager.scene
    pos0 = _sphere_pos(gizmo)
    u, v = project(gizmo, pos0[0])
    gizmo.handle_input({"pick": [u, v]})
    assert gizmo._selected is not None and gizmo._drag_ctx is not None
    idx = gizmo._selected["index"]
    cu = scene.camera.to_uniform()
    fwd = np.asarray(cu.cam_to_world, np.float64)[:3, 2]
    origin = np.asarray(cu.cam_to_world, np.float64)[:3, 3]
    depth0 = np.dot(pos0[idx] - origin, fwd)

    gizmo.handle_input({"drag": [u + 0.1, v]})
    pos1 = _sphere_pos(gizmo)
    moved = pos1[idx] - pos0[idx]
    assert np.linalg.norm(moved) > 1e-3, "drag did not move the sphere"
    depth1 = np.dot(pos1[idx] - origin, fwd)   # the camera plane's depth
    assert abs(depth1 - depth0) < 1e-6 * max(1.0, abs(depth0))
    right = np.asarray(cu.cam_to_world, np.float64)[:3, 0]
    assert np.dot(moved, right) > 0
    assert gizmo.engine.params.frames == -1

    gizmo.handle_input({"drag": [u, v]})       # back to where it was
    np.testing.assert_allclose(_sphere_pos(gizmo)[idx], pos0[idx], atol=1e-5)
    gizmo.handle_input({"drag_end": True})
    assert gizmo._drag_ctx is None


def test_drag_without_pick_is_harmless(gizmo):
    gizmo.handle_input({"pick": [0.0, 0.0]})   # clears selection
    gizmo.handle_input({"drag": [0.5, 0.5]})   # no-op
    gizmo.handle_input({"drag_end": True})


def test_state_reports_selection(gizmo):
    u, v = project(gizmo, _sphere_pos(gizmo)[0])
    gizmo.handle_input({"pick": [u, v]})
    assert gizmo.state()["selected"] == gizmo._selected


def test_pick_instance_aabb():
    eng = _engine(64, 36, SceneName.ROOM)
    vs = ViewerServer(eng)
    vs.handle_input({"pick": [0.5, 0.85]})   # floor, below centre
    assert vs._selected is not None
    eng.scene_manager.shutdown()


def test_aabb_cache_invalidated_on_scene_switch():
    """The instance-AABB pick cache serves no box of an earlier scene after
    a scene switch."""
    eng = _engine(64, 36, SceneName.ROOM)
    vs = ViewerServer(eng)
    scene_a = eng.scene_manager.scene
    box_a = vs._inst_aabb(scene_a, 0)
    assert box_a is not None and len(vs._aabb_cache) == 1
    eng.scene_manager.load_blocking(SceneName.ROOM)   # fresh HostScene
    eng.update(dt=0.01)
    scene_b = eng.scene_manager.scene
    assert scene_b is not scene_a
    vs.handle_input({"pick": [0.5, 0.85]})   # touches _inst_aabb again
    assert vs._aabb_scene is scene_b
    assert all(isinstance(k, int) for k in vs._aabb_cache)
    eng.scene_manager.shutdown()


def test_malformed_pick_drag_payloads_do_not_crash(gizmo):
    """Garbage pick/drag/edit payloads may raise out of handle_input (the
    /ws loop logs and goes on), and a valid message still works after."""
    for bad in ({"pick": 5}, {"pick": [0.3]}, {"drag": "x"},
                {"edit_entity": {"kind": "sphere", "index": "zz"}}):
        try:
            gizmo.handle_input(bad)
        except Exception:
            pass
    gizmo.handle_input({"pick": [0.5, 0.5]})


# ---- tests/test_viewer_ws.py --------------------------------------------
def _ws_client(host, port):
    """Tiny RFC 6455 client: (sock, send_text, recv_text)."""
    s = socket.create_connection((host, port), timeout=10)
    key = base64.b64encode(os.urandom(16)).decode()
    s.sendall((f"GET /ws HTTP/1.1\r\nHost: {host}\r\n"
               "Upgrade: websocket\r\nConnection: Upgrade\r\n"
               f"Sec-WebSocket-Key: {key}\r\n"
               "Sec-WebSocket-Version: 13\r\n\r\n").encode())
    resp = b""
    while b"\r\n\r\n" not in resp:
        resp += s.recv(4096)
    status = resp.split(b"\r\n", 1)[0]
    # RFC 6455: an HTTP/1.1 101; browsers reject an HTTP/1.0 status line
    assert status.startswith(b"HTTP/1.1 101"), status

    def send_text(text):
        data = text.encode()
        mask = os.urandom(4)
        masked = bytes(c ^ mask[i % 4] for i, c in enumerate(data))
        assert len(data) < 126
        s.sendall(bytes([0x81, 0x80 | len(data)]) + mask + masked)

    def recv_text():
        hdr = s.recv(2)
        n = hdr[1] & 0x7F
        if n == 126:
            n = struct.unpack(">H", s.recv(2))[0]
        buf = b""
        while len(buf) < n:
            buf += s.recv(n - len(buf))
        return buf.decode()

    return s, send_text, recv_text


def _serve(vs):
    t = threading.Thread(target=vs.serve_forever, daemon=True)
    t.start()
    for _ in range(200):
        if vs._httpd is not None:
            break
        time.sleep(0.05)
    return t


def _stop(vs, t):
    vs.shutdown()
    t.join(timeout=30)
    assert not t.is_alive()
    vs.engine.scene_manager.shutdown()


@pytest.fixture(scope="module")
def live():
    """A live server on an ephemeral port whose render loop does not run
    (as the reference's fixture means it), so that the engine's parameters
    move only by the input under test."""
    eng = Engine(width=32, height=18, initial_scene=SceneName.METAL,
                 block_on_initial_scene=True, device="cpu")
    vs = ViewerServer(eng, host="127.0.0.1", port=0)
    vs._render_loop = lambda: None
    t = _serve(vs)
    yield vs, eng, vs._httpd.server_address[1]
    _stop(vs, t)


@pytest.fixture(scope="module")
def streaming():
    """A live server with its render loop running."""
    eng = Engine(width=32, height=18, initial_scene=SceneName.METAL,
                 block_on_initial_scene=True, device="cpu")
    vs = ViewerServer(eng, host="127.0.0.1", port=0)
    t = _serve(vs)
    yield vs, eng, vs._httpd.server_address[1]
    _stop(vs, t)


def test_ws_ping_rtt(live):
    vs, eng, port = live
    s, send, recv = _ws_client("127.0.0.1", port)
    t0 = time.perf_counter()
    send(json.dumps({"ping": 123.5}))
    msg = json.loads(recv())
    rtt_ms = (time.perf_counter() - t0) * 1e3
    assert msg == {"pong": 123.5}
    print(f"ws input round-trip {rtt_ms:.2f} ms (CPU, informational)")
    s.close()


def test_ws_input_param_set(live):
    vs, eng, port = live
    s, send, recv = _ws_client("127.0.0.1", port)
    old = eng.params.bounces
    send(json.dumps({"set": {"bounces": old + 2}}))
    send(json.dumps({"ping": 1}))   # fence: input handled before pong
    json.loads(recv())
    assert eng.params.bounces == old + 2
    assert eng.params.frames == -1  # edit reset accumulation
    s.close()


def test_ws_keyboard_motion(live):
    vs, eng, port = live
    s, send, recv = _ws_client("127.0.0.1", port)
    cam = eng.scene_manager.scene.camera
    pos0 = tuple(cam.transform.pos)
    send(json.dumps({"keys": {"w": True}}))
    send(json.dumps({"ping": 2}))
    json.loads(recv())
    moved = cam.update_camera(0.1)   # applies controller velocity
    cam.controller.process_keyboard("w", False)
    assert moved and tuple(cam.transform.pos) != pos0
    s.close()


# ---- PNG in place of JPEG -----------------------------------------------
def _decode_png(data: bytes) -> np.ndarray:
    """The pixels of an 8-bit RGB PNG without filters (as
    ``engine/export.py`` writes it)."""
    assert data[:8] == PNG_SIGNATURE
    pos, idat, size = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            size = struct.unpack(">II", body[:8])
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h = size
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def _wait_frame(vs, after: int = 0):
    deadline = time.monotonic() + 30
    while vs._frame_id <= after and time.monotonic() < deadline:
        time.sleep(0.02)
    assert vs._frame_id > after


def test_frame_is_png_of_the_framebuffer(streaming):
    """GET /frame.png is PNG (checked by signature and decoded): the
    framebuffer of a frame, gamma-encoded and flipped as the export."""
    vs, eng, port = streaming
    _wait_frame(vs)
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/frame.png",
                                timeout=10) as r:
        assert r.headers["Content-Type"] == "image/png"
        data = r.read()
    img = _decode_png(data)
    assert img.shape == (eng.params.height, eng.params.width, 3)
    assert img.max() > 0
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/state",
                                timeout=10) as r:
        state = json.loads(r.read())
    assert state["frame_bytes"] > 0 and state["encode_ms"] >= 0.0


def test_png_frames_are_the_export_of_the_framebuffer():
    """The render loop stores ``png_bytes(framebuffer_to_srgb(fb))`` of
    each frame: after the loop stops, its last PNG (checked as PNG)
    decodes to the export of the framebuffer it left."""
    eng = Engine(width=24, height=16, initial_scene=SceneName.METAL,
                 block_on_initial_scene=True, device="cpu")
    vs = ViewerServer(eng, port=0)
    loop = threading.Thread(target=vs._render_loop)
    loop.start()
    _wait_frame(vs, after=2)
    vs._stop.set()
    loop.join(timeout=30)
    assert not loop.is_alive()
    want = framebuffer_to_srgb(eng.renderer.read_framebuffer())
    assert np.array_equal(_decode_png(vs._frame_png), want)
    assert want.shape == (16, 24, 3) and want.max() > 0
    eng.scene_manager.shutdown()


def test_push_stream_sends_png_parts(streaming):
    """GET /stream.mpng is multipart/x-mixed-replace with image/png parts
    (checked as PNG), one per new frame."""
    vs, eng, port = streaming
    _wait_frame(vs)
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    s.sendall(b"GET /stream.mpng HTTP/1.1\r\nHost: x\r\n\r\n")
    buf = b""
    while buf.count(PNG_SIGNATURE) < 2 or b"\r\n--rt2frame" not in \
            buf[buf.rfind(PNG_SIGNATURE):]:
        chunk = s.recv(65536)
        assert chunk
        buf += chunk
    s.close()
    head, _, rest = buf.partition(b"\r\n\r\n")
    assert b"multipart/x-mixed-replace; boundary=rt2frame" in head
    part_head, _, body = rest.partition(b"\r\n\r\n")
    assert b"Content-Type: image/png" in part_head
    n = int(part_head.split(b"Content-Length: ")[1])
    assert _decode_png(body[:n]).shape == (eng.params.height,
                                            eng.params.width, 3)


_NO_JAX_NO_PIL = """
import json, sys, threading, time, urllib.request
sys.modules["jax"] = None
sys.modules["PIL"] = None
from ray_tracer_2_tpu_torch.engine import Engine
from ray_tracer_2_tpu_torch.scene.scenes import SceneName
from ray_tracer_2_tpu_torch.viewer.server import ViewerServer
eng = Engine(width=16, height=8, initial_scene=SceneName.METAL,
             block_on_initial_scene=True, device="cpu")
vs = ViewerServer(eng, port=0)
t = threading.Thread(target=vs.serve_forever)
t.start()
while vs._httpd is None or vs._frame_id == 0:
    time.sleep(0.02)
url = "http://127.0.0.1:%d" % vs._httpd.server_address[1]
page = urllib.request.urlopen(url + "/", timeout=10).read()
png = urllib.request.urlopen(url + "/frame.png", timeout=10).read()
state = json.loads(urllib.request.urlopen(url + "/state", timeout=10).read())
vs.shutdown()
t.join(30)
eng.scene_manager.shutdown()
leaked = sorted(m for m in sys.modules if m.split(".")[0] in
                ("jax", "PIL", "ray_tracer_2_tpu") and sys.modules[m])
print(json.dumps(dict(page=b"/stream.mpng" in page, png=png[:8].hex(),
                      scene=state["scene"], leaked=leaked,
                      alive=t.is_alive())))
"""


def test_viewer_serves_without_jax_or_pil():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", _NO_JAX_NO_PIL], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out == dict(page=True, png=PNG_SIGNATURE.hex(), scene="Metal",
                       leaked=[], alive=False)
