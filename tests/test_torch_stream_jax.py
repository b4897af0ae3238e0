"""The streaming slice against the JAX package: the pure functions of
``stream/windows.py`` give identical results in both packages, the ledger
schemas are equal, and one synthetic 5-frame clip (windows of 2, overlap 1)
streamed through JAX's ``run_stream_job`` on JAX's ``EditEngine`` and through
the port's, on the same tiny weights (``tests/test_torch_serve_jax.py``'s
carried bundles), gives final videos within 1e-2 — that file's end-to-end
tolerance: each engine edits each window from its own capture — with every
window ``done`` and ``src_err == 0.0`` on both sides.
"""

import numpy as np
import pytest

from tests.test_torch_serve_jax import CONTROLLER, E2E_TOL, REQUEST, paired_engines

from videop2p_tpu.stream import driver as jax_driver
from videop2p_tpu.stream import windows as jax_windows

from videop2p_tpu_torch.stream import driver as port_driver
from videop2p_tpu_torch.stream import windows as port_windows


@pytest.mark.parametrize("total, window, overlap", [
    (5, 2, 1), (14, 4, 1), (20, 8, 2), (8, 8, 2), (128, 8, 2), (480, 8, 2), (17, 5, 0)])
def test_plan_blend_seams_and_record_match_jax(total, window, overlap):
    plan = port_windows.plan_windows(total, window, overlap)
    jplan = jax_windows.plan_windows(total, window, overlap)
    assert [(w.index, w.start, w.stop) for w in plan] == [(w.index, w.start, w.stop)
                                                        for w in jplan]
    assert port_windows.seam_spans(plan) == jax_windows.seam_spans(jplan)
    for n in range(0, window):
        a, b = port_windows.blend_weights(n), jax_windows.blend_weights(n)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    kw = dict(steps=50, latent_size=64, flops_per_window=1.5e15)
    assert port_windows.streaming_plan_record(total, window, overlap, **kw) == \
        jax_windows.streaming_plan_record(total, window, overlap, **kw)
    assert port_windows.streaming_plan_record(total, window, overlap, steps=4,
                                              latent_size=8) == \
        jax_windows.streaming_plan_record(total, window, overlap, steps=4, latent_size=8)


def test_assemble_synthetic_clip_and_window_key_match_jax():
    for args in ((20, 16, 0), (7, 8, 3), (5, 512, 0)):
        clip = port_windows.synthetic_clip(args[0], args[1], seed=args[2])
        assert np.array_equal(clip, jax_windows.synthetic_clip(args[0], args[1], seed=args[2]))
    plan = port_windows.plan_windows(14, 4, 1)
    rng = np.random.default_rng(0)
    outputs = {w.index: rng.random((4, 3, 3, 3), dtype=np.float32) for w in plan}
    out = port_windows.assemble_video(plan, outputs, 14)
    jout = jax_windows.assemble_video(jax_windows.plan_windows(14, 4, 1), outputs, 14)
    assert out.dtype == jout.dtype and np.array_equal(out, jout)
    frames = port_windows.synthetic_clip(4, 8, seed=0)
    for extra in (None, {"blend_word": ["a", "b"], "cross_replace_steps": 0.8}):
        assert port_windows.window_key("fp", frames, ["a", "b"], seed=3, extra=extra) == \
            jax_windows.window_key("fp", frames, ["a", "b"], seed=3, extra=extra)


def test_stream_ledger_schemas_match_jax():
    for name in ("STREAM_HEALTH_FIELDS", "STREAM_WINDOW_FIELDS", "STREAM_SEAM_FIELDS"):
        assert getattr(port_driver, name) == getattr(jax_driver, name), name
    from videop2p_tpu.stream.manifest import MANIFEST_VERSION, WINDOW_STATUSES

    from videop2p_tpu_torch.stream import manifest

    assert (manifest.MANIFEST_VERSION, manifest.WINDOW_STATUSES) == (
        MANIFEST_VERSION, WINDOW_STATUSES)


def test_stream_job_matches_jax(tmp_path):
    from videop2p_tpu.stream import run_stream_job as jax_run

    from videop2p_tpu_torch.stream import run_stream_job

    jeng, peng = paired_engines(tmp_path, jax_warm={"batch_sizes": ()}, port_warm={})
    clip = port_windows.synthetic_clip(5, 16, seed=1)
    request_kwargs = dict(CONTROLLER)
    try:
        jres = jax_run(jeng, clip, REQUEST["prompts"], job_dir=str(tmp_path / "jax_job"),
                       overlap=1, max_inflight=1, request_kwargs=request_kwargs)
        pres = run_stream_job(peng, clip, REQUEST["prompts"], job_dir=str(tmp_path / "port_job"),
                              overlap=1, max_inflight=1, request_kwargs=request_kwargs)
    finally:
        jeng.close()
        peng.close()
    for res in (jres, pres):
        h = res.health
        assert res.complete and h["windows_done"] == 4 and h["windows_passthrough"] == 0
        assert h["src_err_max"] == 0.0
        assert [r["status"] for r in res.windows] == ["done"] * 4
        assert all(r["src_err"] == 0.0 for r in res.windows)
    assert pres.video.shape == jres.video.shape == (5, 16, 16, 3)
    np.testing.assert_allclose(pres.video, np.asarray(jres.video), atol=E2E_TOL, rtol=0)
    # the edit moved the clip away from its source
    src = clip.astype(np.float32) / 255.0
    assert np.abs(pres.video - src).max() > 0.1
    # the identities differ only by the spec fingerprint (impl="torch")
    jid, pid = dict(jres.manifest.identity), dict(pres.manifest.identity)
    assert jid.pop("spec_fingerprint") != pid.pop("spec_fingerprint")
    assert jid == pid
