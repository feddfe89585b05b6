"""The chip smoke's interactive configuration on other seeds: one
``Slam`` session on the card for each seed (default 30, 32, 33; the smoke
itself runs 31), one JSON line each with the closures, the final
keyframe's camera-centre error and the odometry's.

    python3 tools/torch_seed_spread.py [seed ...]
"""
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def main():
    from slam_tpu_torch.map.keyframe import MapperInput, Pose
    from slam_tpu_torch.params import Parameters, ParametersSlam
    from slam_tpu_torch.pipeline.mapper_helpers import check_consistency
    from slam_tpu_torch.pipeline.slam_api import Slam
    from slam_tpu_torch.utils.synthetic import default_camera

    name, smi = cs.phase_device()
    cam = default_camera(cs.WIDTH, cs.HEIGHT)
    params = Parameters(slam=ParametersSlam(**cs.IA_PARAMS))
    for seed in [int(a) for a in sys.argv[1:]] or [30, 32, 33]:
        cs.IA_SEED = seed
        world, frames, odom = cs.make_interactive_inputs(cam)
        slam = Slam.build(params, device="cuda")
        inputs = [MapperInput(
            frame=frames[i], camera=cam, track_ids=np.zeros(0, np.int64),
            track_pts=np.zeros((0, 2), np.float32), track_depths=None,
            pose_trail=[Pose(frame_number=j, t=world.times[j],
                             pose_cw=odom[j].copy())
                        for j in range(i, max(-1, i - 6), -1)],
            t=world.times[i]) for i in range(cs.IA_FRAMES)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, mi in enumerate(inputs):
            if i + 1 < cs.IA_FRAMES:
                slam.mapper.prefetch(inputs[i + 1])
            slam.add_frame(frame=mi.frame, pose_trail=mi.pose_trail,
                           features_ids=mi.track_ids,
                           features_pts=mi.track_pts, camera=cam).result()
        assert slam.end().result()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        db = slam.mapper.map_db
        check_consistency(db)
        centre = lambda T: -T[:3, :3].T @ T[:3, 3]
        final = db.latest_keyframe()
        k = int(final.id)
        err = float(np.linalg.norm(centre(final.pose_cw)
                                   - centre(world.poses_cw[k])))
        odom_err = float(np.linalg.norm(centre(odom[k])
                                        - centre(world.poses_cw[k])))
        row = dict(seed=seed, closures=[(int(e.kf_id1), int(e.kf_id2))
                                        for e in db.loop_closure_edges],
                   keyframes=len(db.keyframes), map_points=len(db.map_points),
                   final_kf=k, err_m=err, odom_err_m=odom_err,
                   beats_odometry=err < odom_err,
                   fps=cs.IA_FRAMES / wall, card=smi)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
