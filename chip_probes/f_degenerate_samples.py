"""Why the card's and the CPU's robust F differ on the scene: every
hypothesis of ``estimate_fundamental_robust`` (7pt and 8pt) on the card and
on the CPU, sample by sample.

    python3 chip_probes/f_degenerate_samples.py

Runs phase 10's F rows (the flagship's correspondences of
``chip_smoke.render_scene``, normalized, 96 x 12, the phase's seeded
streams) with the family's solver wrapped to record each batch's samples
and models on both devices. Prints one JSON line per row: how many
samples' models differ between the devices (unit norm, sign fixed, max
entry > 1e-3), the smallest singular values of those samples' normalized
design matrices against the others' (float64), the winner's sample, and
the most inliers any hypothesis reaches on each device. Needs the card
(``--cpu`` rehearses it with the CPU in the card's place).
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from matchinglib_poselib_torch import config as cfg  # noqa: E402
from matchinglib_poselib_torch.models import pipeline  # noqa: E402
from matchinglib_poselib_torch.ops import geometry as geo  # noqa: E402
from matchinglib_poselib_torch.ops import robust  # noqa: E402


def design_sv(s1, s2):
    """float64 singular values of the Hartley-normalized epipolar rows of
    each sample (S, k, 2) -> (S, 9), descending."""
    out = []
    for a, b in zip(s1.astype(np.float64), s2.astype(np.float64)):
        pa = a - a.mean(0)
        pb = b - b.mean(0)
        pa = pa * np.sqrt(2) / np.mean(np.linalg.norm(pa, axis=1))
        pb = pb * np.sqrt(2) / np.mean(np.linalg.norm(pb, axis=1))
        u1, v1 = pa[:, 0], pa[:, 1]
        u2, v2 = pb[:, 0], pb[:, 1]
        rows = np.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2,
                         u1, v1, np.ones_like(u1)], axis=1)
        s = np.linalg.svd(rows, compute_uv=False)
        out.append(np.pad(s, (0, 9 - len(s))))
    return np.asarray(out)


def main(argv=None) -> int:
    # --cpu: rehearse the probe with the CPU in the card's place
    if "--cpu" in (argv or sys.argv[1:]):
        dev = torch.device("cpu")
    elif torch.cuda.is_available():
        dev = torch.device("cuda:0")
    else:
        print("no CUDA device", file=sys.stderr)
        return 2
    det = cfg.DetectorConfig(kind="FAST", max_keypoints=2048,
                             fast_threshold=12.0)
    rcfg = dataclasses.replace(
        cfg.RobustConfig(batch_hypotheses=96, max_batches=12),
        check_degeneracy=False)
    img1, img2, K, _, _ = chip_smoke.render_scene(0)
    corr = pipeline.get_correspondences(
        torch.from_numpy(img1).to(dev), torch.from_numpy(img2).to(dev), det,
        cfg.DescriptorConfig(), cfg.MatchingConfig(matcher_name="GMBSOF"))
    Kt = torch.from_numpy(K).to(dev)
    x1, x2 = geo.img_to_cam(corr.pts1, Kt), geo.img_to_cam(corr.pts2, Kt)
    th_sq = (rcfg.threshold_px / float(K[0, 0] + K[1, 1]) * 2.0) ** 2
    rng = np.random.default_rng(50)  # library_estimators' streams, seed 0
    nb, B = rcfg.max_batches, rcfg.batch_hypotheses
    streams = {k: torch.from_numpy(rng.random((nb, B, k)).astype(
        np.float32)) for k in (7, 8)}
    if dev.type == "cuda":
        print(json.dumps({"card": chip_smoke._nvidia_smi()}))
    for k, fam_name in ((7, "fundamental_7pt_family"),
                        (8, "fundamental_8pt_family")):
        orig = getattr(robust, fam_name)
        rec = {}
        for where in ("card", "cpu"):
            log = []

            def wrapped(orig=orig, log=log):
                fam = orig()

                def solve(s1, s2):
                    M, v = fam.solve(s1, s2)
                    log.append((s1.cpu().numpy(), s2.cpu().numpy(),
                                M.cpu().numpy(), v.cpu().numpy()))
                    return M, v

                return fam._replace(solve=solve)

            setattr(robust, fam_name, wrapped)
            d = dev if where == "card" else torch.device("cpu")
            res = robust.estimate_fundamental_robust(
                x1.to(d), x2.to(d), corr.mask.to(d), corr.quality.to(d),
                rcfg, th_sq, use_8pt=k == 8, uniforms=streams[k].to(d))
            setattr(robust, fam_name, orig)
            rec[where] = (log, res)
        (lc, rc), (lp, rp) = rec["card"], rec["cpu"]
        s1 = np.concatenate([b[0] for b in lp])
        s2 = np.concatenate([b[1] for b in lp])
        same_samples = all(np.array_equal(a[0], b[0])
                           for a, b in zip(lc, lp))
        Mc = np.concatenate([b[2] for b in lc])
        Mp = np.concatenate([b[2] for b in lp])
        vc = np.concatenate([b[3] for b in lc])
        vp = np.concatenate([b[3] for b in lp])
        S, m = Mc.shape[:2]

        def unit(M):
            M = M.reshape(-1, 9).astype(np.float64)
            M = M / np.linalg.norm(M, axis=1, keepdims=True)
            i = np.argmax(np.abs(M), axis=1)
            return M * np.sign(M[np.arange(len(M)), i])[:, None]

        diff = np.abs(unit(Mc) - unit(Mp)).max(1).reshape(S, m)
        differs = np.any((diff > 1e-3) & vc & vp, axis=1)
        sv = design_sv(s1, s2)
        # the (k+1)-th and k-th smallest of the k rows' singular values
        small = sv[:, k - 1] / sv[:, 0]
        cnt = []
        for M in (Mc, Mp):
            e = robust._sampson_family_error(
                torch.from_numpy(M.reshape(-1, 3, 3)).to(dev), x1, x2)
            inl = (e < th_sq) & corr.mask[None]
            cnt.append(inl.sum(1).cpu().numpy().reshape(S, m))
        win_c = unit(rc.model.cpu().numpy()[None])[0]
        win_p = unit(rp.model.cpu().numpy()[None])[0]
        idx_c = int(np.argmin(np.abs(unit(Mc) - win_c).max(1))) // m
        idx_p = int(np.argmin(np.abs(unit(Mp) - win_p).max(1))) // m
        print(json.dumps({
            "k": k, "samples": int(S), "batches_card": len(lc),
            "batches_cpu": len(lp), "same_samples": same_samples,
            "samples_differing": int(differs.sum()),
            "smallest_sv_ratio_differing": np.sort(small[differs])[:10]
            .tolist(),
            "smallest_sv_ratio_others_min": float(small[~differs].min()),
            "winner_sample_card": idx_c, "winner_sample_cpu": idx_p,
            "winner_card_sv_ratio": float(small[idx_c]),
            "winner_card_differs": bool(differs[idx_c]),
            "n_inliers_card": int(rc.n_inliers),
            "n_inliers_cpu": int(rp.n_inliers),
            "max_count_card_hyps": int(cnt[0].max()),
            "max_count_cpu_hyps": int(cnt[1].max()),
            "card_winner_sample_on_cpu_counts": cnt[1][idx_c].tolist(),
        }))
        if k == 8:
            print(json.dumps(stage_split(s1, s2, dev)))
    return 0


def stage_split(s1, s2, dev):
    """The 8pt F solve of the recorded samples stage by stage, on `dev`
    and on the CPU in float32 against the CPU in float64: the nullspace
    of A^T A (``solvers.nullspace_from_ata``, eigh) and the rank-2
    projection (``torch.linalg.svd``) of one shared float32 nullspace.
    Returns the percentiles (50, 90) of each stage's distance."""
    from matchinglib_poselib_torch.ops import solvers

    def ns(x1, x2):
        ones = torch.ones(x1.shape[:-1], dtype=x1.dtype, device=x1.device)
        a, _ = geo.normalize_points(x1, ones)
        b, _ = geo.normalize_points(x2, ones)
        return solvers.nullspace_from_ata(solvers.epipolar_rows(a, b), 1)[
            ..., 0]

    def proj(v):
        U, sv, Vt = torch.linalg.svd(v.reshape(-1, 3, 3))
        sv = torch.cat([sv[:, :2], torch.zeros_like(sv[:, 2:])], dim=1)
        return ((U * sv[:, None, :]) @ Vt).reshape(-1, 9)

    def dist(a, b):
        a = _unit(a.double().cpu().numpy())
        b = _unit(b.double().cpu().numpy())
        d = np.minimum(np.linalg.norm(a - b, axis=1),
                       np.linalg.norm(a + b, axis=1))
        return [float(np.percentile(d, q)) for q in (50, 90)]

    x1, x2 = torch.from_numpy(s1), torch.from_numpy(s2)
    n64 = ns(x1.double(), x2.double())
    n32 = ns(x1, x2)
    n_dev = ns(x1.to(dev), x2.to(dev))
    n_dev64 = ns(x1.double().to(dev), x2.double().to(dev))
    return {"stage": "8pt split",
            "eigh_cpu32_vs_f64": dist(n32, n64),
            "eigh_card32_vs_f64": dist(n_dev, n64),
            "eigh_card64_vs_f64": dist(n_dev64, n64),
            "svd_cpu32_vs_f64": dist(proj(n32), proj(n32.double())),
            "svd_card32_vs_f64": dist(proj(n32.to(dev)),
                                      proj(n32.double()))}


def _unit(M):
    M = M.reshape(-1, 9)
    M = M / np.linalg.norm(M, axis=1, keepdims=True)
    i = np.argmax(np.abs(M), axis=1)
    return M * np.sign(M[np.arange(len(M)), i])[:, None]


if __name__ == "__main__":
    sys.exit(main())
