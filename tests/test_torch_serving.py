"""PyTorch port: ``hd_yolo_tpu_torch/serving.py`` and ``Detections.render``
against the JAX package's server and ``render``, on the same converted
weights (``yolov5s-test`` at 128 px tiles, f32, the CPU ``Detector``).

Both servers run on 127.0.0.1 in threads.  ``/healthz``, a PNG tile and a
PNG slide: the port answers with the JAX server's records (same rows,
labels and names; coordinates and confidences to 1e-3, as
``test_torch_slice.py`` holds the forward).  An unknown ``?task=`` raises
in both handlers, so both clients see the connection dropped.  ``render``
draws the same records pixel for pixel.
"""

import http.client
import json
import pickle
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hd_yolo_tpu.serving as jserving
import hd_yolo_tpu_torch.serving as tserving
from hd_yolo_tpu.detector import Detections as JaxDetections
from hd_yolo_tpu.detector import Detector as JaxDetector
from hd_yolo_tpu_torch.detector import Detections, Detector
from torch_port_common import random_variables

SIZE = 128
KW = dict(max_masks=16, pre_nms_topk=256)
LABELS = {1: "tumor", 2: "stromal"}


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    jdet = JaxDetector("yolov5s-test", "hyp-nuclei", input_size=SIZE, dtype=jnp.float32,
                       labels_text=LABELS, **KW)
    variables = random_variables(jdet.model, (1, SIZE, SIZE, 3), seed=4, obj_bias=1.0)
    jdet.variables = variables
    path = tmp_path_factory.mktemp("w") / "weights.pkl"
    path.write_bytes(pickle.dumps(variables))
    det = Detector("yolov5s-test", "hyp-nuclei", weights=str(path), input_size=SIZE,
                   dtype=torch.float32, device="cpu", labels_text=LABELS, **KW)
    jserving._detector, tserving._detector = jdet, det
    running = []
    for mod in (jserving, tserving):
        server = ThreadingHTTPServer(("127.0.0.1", 0), mod.Handler)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        running.append(server)
    yield {"jax": f"http://127.0.0.1:{running[0].server_address[1]}",
           "port": f"http://127.0.0.1:{running[1].server_address[1]}", "det": det, "jdet": jdet}
    for server in running:
        server.shutdown()
        server.server_close()


def post(url, img, ctype="image/png"):
    ok, enc = cv2.imencode(".png", cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    assert ok
    body = enc.tobytes()
    if ctype.startswith("multipart"):
        body = (b"--XyZ\r\nContent-Disposition: form-data; name=\"image\"; filename=\"t.png\"\r\n"
                b"Content-Type: image/png\r\n\r\n" + body + b"\r\n--XyZ--\r\n")
    req = urllib.request.Request(url, data=body, headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.load(r)


def compare_rows(got, want):
    """The same rows: each port row has its JAX row (same image, task,
    class and name; coordinates and confidence to 1e-3), one to one.  Rows
    whose confidences agree to float rounding may come in either order
    (the slide has hundreds of near-tied scores), so rows are paired by
    their values and the confidence sequence is held in order."""
    assert len(got) == len(want) > 0
    cols = ("xmin", "ymin", "xmax", "ymax", "confidence")
    g = np.array([[r[k] for k in cols] for r in got])
    w = np.array([[r[k] for k in cols] for r in want])
    d = np.abs(g[:, None, :] - w[None, :, :]).max(-1)
    j = d.argmin(1)
    assert sorted(j.tolist()) == list(range(len(want)))
    assert d[np.arange(len(got)), j].max() <= 1e-3
    for r, k in zip(got, j):
        for key in ("image", "task", "class", "name"):
            assert r[key] == want[k][key], key
    np.testing.assert_allclose(g[:, 4], w[:, 4], rtol=0, atol=1e-3)


def test_healthz_and_unknown_path(servers):
    for side in ("jax", "port"):
        with urllib.request.urlopen(servers[side] + "/healthz", timeout=30) as r:
            assert r.status == 200 and json.load(r) == {"status": "ok"}
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(servers[side] + "/nothing", timeout=30)
        assert e.value.code == 404


@pytest.mark.parametrize("ctype", ["image/png", "multipart/form-data; boundary=XyZ"])
def test_tile_records_match_jax(servers, rng, ctype):
    img = rng.integers(0, 255, (100, 150, 3), dtype=np.uint8)
    path = "/v1/object-detection/hd_yolo"
    (jc, want), (tc, got) = (post(servers[s] + path, img, ctype) for s in ("jax", "port"))
    assert jc == tc == 200
    compare_rows(got, want)
    assert all(0 <= r["xmin"] <= 150 and 0 <= r["ymax"] <= 100 for r in got)


def test_slide_records_match_jax(servers, rng):
    big = rng.integers(0, 255, (200, 260, 3), dtype=np.uint8)
    path = "/v1/slide/hd_yolo?task=det"
    (jc, want), (tc, got) = (post(servers[s] + path, big) for s in ("jax", "port"))
    assert jc == tc == 200
    compare_rows(got, want)
    # slide boxes are clipped to the slide's far edges (they may start above 0)
    assert all(r["xmax"] <= 260 and r["ymax"] <= 200 for r in got)


def test_respond_equals_a_direct_call(servers, rng):
    img = rng.integers(0, 255, (128, 128, 3), dtype=np.uint8)
    code, rows = tserving._respond(img, False, None)
    assert code == 200 and rows == servers["det"](img).to_records()


@pytest.mark.parametrize("path", ["/v1/object-detection/hd_yolo?task=nope",
                                  "/v1/slide/hd_yolo?task=nope"])
def test_unknown_task_drops_the_connection_as_jax_does(servers, rng, path):
    """The JAX handler raises on an unknown task and the client gets no
    response; the port behaves the same (ROADMAP C.3)."""
    img = rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)
    for side in ("jax", "port"):
        with pytest.raises((http.client.RemoteDisconnected, ConnectionError,
                            urllib.error.URLError)):
            post(servers[side] + path, img)
    with pytest.raises(KeyError):
        tserving._respond(img, "slide" in path, "nope")


def test_bad_and_missing_images_answer_400(servers):
    for side in ("jax", "port"):
        for body in (b"not an image", b""):
            req = urllib.request.Request(servers[side] + "/v1/object-detection/x", data=body,
                                         headers={"Content-Type": "image/png"})
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=30)
            assert e.value.code == 400


def test_render_equals_jax_pixel_for_pixel(servers, rng):
    img = rng.integers(0, 255, (140, 180, 3), dtype=np.uint8)
    res = servers["det"](img)
    rec = res.records[0]["det"]
    assert len(rec["boxes"]) > 0 and "masks" in rec
    want = JaxDetections(res.records, res.images, LABELS).render(0)
    got = res.render(0)
    assert got.dtype == np.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(got, want)
    assert (got != img).any()
    float_img = [img.astype(np.float32) / 255.0]
    np.testing.assert_array_equal(Detections(res.records, float_img, LABELS).render(0, "det"),
                                  JaxDetections(res.records, float_img, LABELS).render(0, "det"))
