"""A whole run of each cell's driver on the CPU at a small size (the look
for a card skipped), with the cell's own limits: sound, `correct` is
true; with the timed path broken underneath, `correct` comes out false,
once for each fault the cells can have. (They run on one chip, so no
exchange between chips can be left out.)

- state_unchanged: the map step returns the back-end state it was given;
- later_half_unmapped: half of each chunk's scans, its later half, left
  out of the map step (their map poses stay the last one made);
- half_dropped: half of every scan's points left out of the feed, the
  rest mapped as if they were all;
- answer_altered: each map pose moved 5 cm where the map step makes it;
- labels_altered: K1's component labels of the upper half of the rows
  broken into single pixels where the prepass makes them.
"""

import time

import numpy as np
import pytest
import torch

import lego_loam_torch.pipeline as port_pipeline
from loambench import harness, run

SMALL = {"mapping": {"max_keyframes": 64, "max_submap_corner": 4096, "max_submap_surf": 8192,
                     "history_keyframe_search_num": 4, "loop_icp_src_stride": 4, "posegraph_anchor_stride": 8}}
CHUNK = 4
CELLS = {"vlp16.replay.lap": {"laps": 1, "straight": 8, "turn": 3, "chunk": CHUNK, "setup_chunks": 1}}


def plant(monkeypatch, fault):
    if fault == "state_unchanged":
        orig = port_pipeline.backend_step_ds

        def step(state, *a, **kw):
            _, _, diag = orig(state, *a, **kw)
            return state, (state.R_map.clone(), state.t_map.clone()), diag

        monkeypatch.setattr(port_pipeline, "backend_step_ds", step)
    elif fault == "later_half_unmapped":
        orig, orig_chunk = port_pipeline.backend_step_ds, port_pipeline.LegoLoamPipeline.process_chunk
        seen = [0]

        def chunk(self, *a, **kw):
            seen[0] = 0
            return orig_chunk(self, *a, **kw)

        def step(state, *a, **kw):
            seen[0] += 1
            out = orig(state, *a, **kw)
            if seen[0] <= CHUNK // 2:
                return out
            return state, (state.R_map.clone(), state.t_map.clone()), out[2]

        monkeypatch.setattr(port_pipeline.LegoLoamPipeline, "process_chunk", chunk)
        monkeypatch.setattr(port_pipeline, "backend_step_ds", step)
    elif fault == "half_dropped":
        def halve(scans):
            return [np.where(np.arange(len(p))[:, None] < len(p) // 2, p, np.nan) for p in scans]

        orig = port_pipeline.LegoLoamPipeline._prep_many
        monkeypatch.setattr(port_pipeline.LegoLoamPipeline, "_prep_many", lambda self, scans: orig(self, halve(scans)))
    elif fault == "answer_altered":
        orig = port_pipeline.backend_step_ds

        def step(*a, **kw):
            state, (R, t), diag = orig(*a, **kw)
            return state, (R, t + torch.tensor([0.0, 0.05, 0.0], device=t.device)), diag

        monkeypatch.setattr(port_pipeline, "backend_step_ds", step)
    elif fault == "labels_altered":
        orig = port_pipeline.converged_labels

        def labels(grid, cfg):
            raw, cand = orig(grid, cfg)
            H, W = raw.shape[-2:]
            own = torch.arange(H * W, dtype=raw.dtype, device=raw.device).view(H, W)
            upper = torch.arange(H, device=raw.device)[:, None] >= H // 2
            return torch.where(upper & cand, own, raw), cand

        monkeypatch.setattr(port_pipeline, "converged_labels", labels)


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("fault", [None, "state_unchanged", "later_half_unmapped", "half_dropped", "answer_altered",
                                   "labels_altered"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    torch.set_num_threads(2)
    bench = harness.load_bench()
    plant(monkeypatch, fault)
    r = run.prepare(bench, cell, 2 ** 33 + 17, 0.1, False, torch.device("cpu"),
                    {"traffic": CELLS[cell], "lego": SMALL}, t_start=time.perf_counter())
    result, checks = run.execute(bench, r)
    assert checks
    assert result["correct"] is (fault is None), checks
