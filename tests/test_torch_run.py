"""The per-scan `run` of the port against the reference's, with loop
closure on and the global map published, and `request_stop` in `run` and
`run_chunked`.

Both pipelines start from the reference's initial states, draw the
reference's RANSAC scores and see injected candidate probes (no candidate,
as tests/test_torch_loop_flow.py injects them), which record the frame at
which each check is made: `run` sends each scan through `process_scan`,
so both check after every `loop_every_n_frames`-th mapped frame and at the
drain, and store the float64 time rounded to float32 with each keyframe.
The port's drain reads every queued probe where the reference reads
only the oldest (ROADMAP, standing divergences), so it records one more
check diagnostic. Tolerances: check frames, keyframe and log times and the number of
published global maps exact; map poses within 1.5 cm (as
tests/test_torch_pipeline.py); the published map's voxel count within 2%
(its keyframe clouds carry the flat-feature tie divergence)."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lego_loam_tpu.pipeline import LegoLoamPipeline as RefPipeline
from lego_loam_torch.convert import backend_state_from_reference, odometry_state_from_reference
from lego_loam_torch.io.synthetic import straight_trajectory, swept_scan_sequence
from lego_loam_torch.pipeline import LegoLoamPipeline

from _torch_parity import loop_ref_cfg, pair, ref_scores, small_ref_cfg

N_FRAMES = 5
NONE = [0.0, math.inf, 40.0, 0.0]  # [cand_slot, cand_dist, n_kf, cur_slot]: no candidate


def _with_probe(pipe, seen, ref: bool):
    """Replace the pipeline's candidate probe with NONE, recording the
    frame of each call."""
    if ref:
        def probe(_bs):
            seen.append(pipe.frame_idx)
            return jnp.asarray(NONE, jnp.float32)
    else:
        def probe():
            seen.append(pipe.frame_idx)
            return torch.tensor(NONE)
    pipe._loopinfo_probe = probe


@pytest.fixture(scope="module")
def runs():
    base = loop_ref_cfg()
    ref_cfg, cfg = pair(dataclasses.replace(
        base,
        mapping=dataclasses.replace(base.mapping, global_map_every_n_frames=2),
        pipeline=dataclasses.replace(base.pipeline, publish_global_map=True),
    ))
    poses = straight_trajectory(N_FRAMES, speed=0.15)
    scans = list(swept_scan_sequence(poses, cfg, noise=0.005))
    ref = RefPipeline(ref_cfg)
    ours = LegoLoamPipeline(cfg, device="cpu", ground_scores=lambda i: ref_scores(cfg, i))
    ours.fstate = odometry_state_from_reference(jax.device_get(ref.fstate), "cpu")
    ours.bstate = backend_state_from_reference(jax.device_get(ref.bstate), "cpu")
    checks = ([], [])
    _with_probe(ref, checks[0], True)
    _with_probe(ours, checks[1], False)
    counts = ([], [])
    for p, c in zip((ref, ours), counts):
        publish = p._maybe_publish_global_map

        def count(publish=publish, p=p, c=c):
            publish()
            c.append(p.global_map_count)
        p._maybe_publish_global_map = count
    ref_out = ref.run(scans)
    out = ours.run(scans)
    return ref, ours, ref_out, out, checks, counts


def test_run_is_per_scan(runs):
    """The same frames checked (every 2nd mapped frame and the drain's
    final probe), the same keyframe times bit for bit, map poses within
    1.5 cm."""
    ref, ours, ref_out, out, (ref_checks, checks), _ = runs
    assert checks == ref_checks == [0, 2, 4, N_FRAMES]
    # each probe is read two checks late; the port's drain reads every
    # queued probe, the reference's only the oldest (a recorded divergence)
    assert len(ours.loop_diag) == len(ref.loop_diag) + 1 == 4
    assert ours.loop_diag[:3] == ref.loop_diag
    np.testing.assert_array_equal(ours.bstate.kf_time.numpy(), np.asarray(jax.device_get(ref.bstate.kf_time)))
    assert int(ours.bstate.n_kf) == int(ref.bstate.n_kf)
    assert ours.trajectory["times"] == ref.trajectory["times"] == [i * 0.1 for i in range(N_FRAMES)]
    for k in ("map_positions", "odom_positions", "fused_positions"):
        assert out[k].shape == ref_out[k].shape == (N_FRAMES, 3)
    np.testing.assert_allclose(out["map_positions"], ref_out["map_positions"], atol=1.5e-2, rtol=0)


def test_run_publishes_global_map(runs):
    """With publish_global_map, a global map every 2nd mapped frame from
    the process_scan path, as in the reference: the same count after each
    mapped frame, and maps of nearly the same size."""
    ref, ours, _, _, _, (ref_counts, counts) = runs
    assert counts == ref_counts == [0, 1, 1, 2, 2]
    assert ours.global_map_count == ref.global_map_count == 2
    a, b = ref.latest_global_map, ours.latest_global_map
    assert b.shape[1] == 3 and np.isfinite(b).all()
    assert abs(len(a) - len(b)) <= 0.02 * len(a), (len(a), len(b))


def test_run_signature():
    import inspect

    for name in ("run", "run_chunked", "process_scan", "process_chunk", "stage_chunk", "request_stop",
                 "save_artifacts"):
        ours = inspect.signature(getattr(LegoLoamPipeline, name))
        ref = inspect.signature(getattr(RefPipeline, name))
        assert list(ours.parameters) == list(ref.parameters), name


@pytest.mark.parametrize("entry,chunk,stop_at,done", [
    ("run", None, 1, 2),  # before the next scan
    ("run_chunked", 2, 0, 2),  # at the chunk boundary
    ("run_chunked", 3, 2, 3),  # before the ragged tail
])
def test_request_stop(entry, chunk, stop_at, done):
    """`request_stop` made while frame `stop_at` runs ends the drive after
    `done` frames, and the trajectories returned cover those frames."""
    _, cfg = pair(small_ref_cfg(max_keyframes=8))
    scans = list(swept_scan_sequence(straight_trajectory(4, speed=0.15), cfg, noise=0.005))
    pipe = LegoLoamPipeline(cfg, device="cpu")
    draw = pipe._ground_scores

    def scores(frame):
        if frame == stop_at:
            pipe.request_stop()
        return draw(frame)

    pipe._ground_scores = scores
    out = pipe.run(scans) if entry == "run" else pipe.run_chunked(scans, chunk=chunk)
    assert pipe.frame_idx == done
    assert out["map_positions"].shape == out["odom_positions"].shape == (done, 3)
    assert np.isfinite(out["map_positions"]).all()
