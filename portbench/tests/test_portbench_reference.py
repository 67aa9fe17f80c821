"""The frozen reference against the program's plain route on the CPU, and
rays_traced against the lanes the program hands its dense intersector."""

import torch

from portbench import drive, port, scenes
from portbench.kinds import render
from portbench.reference import frame as RF
from portbench.reference import scene as RS


def _frames(config_name, traffic_name, n, size=(40, 24)):
    cfg = drive.load("configs", config_name)
    traffic = drive.load("traffic", traffic_name)
    w, h = size
    sess = render.Session(cfg, traffic, 2**40 + 123, "cpu", {"width": w, "height": h})
    outs = []
    for _ in range(n):
        out = sess.step()
        outs.append((sess.k - 1, out.final.clone(), port.as_fields(sess.r.state)))
    return sess, outs


def _against_reference(sess, outs):
    refs = render.render_frames(sess, [(k, None) for k, _, _ in outs], "cpu")
    return [render.compare_frame(f, s, rf, rst) for (_, f, s), (_, rf, rst) in zip(outs, refs)]


def test_cornell_frames_equal_the_plain_route():
    rows = _against_reference(*_frames("cornell-1080p", "orbit", 3))
    for r in rows:
        assert r["final_mean_err"] < 1e-6 and r["final_bad_px"] == 0
        assert r["state_mean_err"] < 1e-6 and r["state_int_px"] == 0 and r["frame_idx_err"] == 0


def test_edited_heightfield_past_the_dense_size_equals_the_plain_walk():
    """The reference's linear BVH (over 16,384 triangles) and its scene
    edits, against the program's plain route, on a light being dragged."""
    cfg = drive.load("configs", "cornell-1080p")
    cfg["scene"] = {"generator": "heightfield", "n": 96}      # 18,052 triangles: the BVH route
    traffic = {"kind": "render", "camera": {"path": "still"}, "warmup_steps": 1, "traced_steps": 1,
               "edit": {"instance": "light", "axis": 0, "amplitude": 0.3, "period_steps": 120}}
    sess = render.Session(cfg, traffic, 5, "cpu", {"width": 32, "height": 20})
    outs = []
    for _ in range(2):
        out = sess.step()
        outs.append((sess.k - 1, out.final.clone(), port.as_fields(sess.r.state)))
    for r in _against_reference(sess, outs):
        assert r["final_mean_err"] < 1e-6 and r["state_int_px"] == 0


def test_reference_flattening_matches_the_program():
    desc = scenes.make({"generator": "cornell_box"})
    rs = RS.build(desc, 40, 24, "cpu")
    arr = port.scene(desc, RS.look_at((0, 0, 3.4), (0, 0, 0))).flatten(device="cpu")
    assert torch.equal(rs.tri_pos, arr.tri_pos) and torch.equal(rs.tri_nrm, arr.tri_nrm)
    assert torch.equal(rs.inst_normal, arr.inst_normal_transform)
    assert torch.equal(rs.light_cdf, arr.lights_cdf) and arr.meta.n_world_tris == 36


def test_rays_traced_counts_the_lanes_handed_to_the_dense_intersector(monkeypatch):
    import svgf_tpu_torch.ops.intersect as I

    lanes = []
    plain = I.intersect_dense

    def counting(scene, ro, rd, active=None, **kw):
        lanes.append(ro.shape[0] if active is None else int(active.sum()))
        return plain(scene, ro, rd, active=active, **kw)

    monkeypatch.setattr(I, "intersect_dense", counting)
    cfg = drive.load("configs", "cornell-1080p")
    sess = render.Session(cfg, drive.load("traffic", "orbit"), 3, "cpu",
                               {"width": 40, "height": 24})
    sess.step()
    assert len(lanes) == 1 + cfg["render"]["bounces"]
    assert sess.counters()["rays_traced"] == sum(lanes)


def test_initial_state_matches_the_program():
    st = RF.initial_state(4, 6, torch.float16, "cpu")
    from svgf_tpu_torch.render.types import TemporalState

    want = port.as_fields(TemporalState.initial(4, 6, torch.float16, device="cpu"))
    for k in ("color", "moments", "history_len", "taa_history"):
        assert torch.equal(st[k], want[k])
    for k, v in want["gbuffer"].items():
        assert torch.equal(getattr(st["gbuffer"], k), v)
