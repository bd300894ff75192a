"""Node-layer 3D demo: point-cloud localization against a voxel world.

Builds a synthetic warehouse-like voxel map (walls + columns), writes it to a
binary .bt octree, feeds it through the octomap ingestion path, then drives a
Node3D with simulated odometry + lidar clouds using the reference's 3D launch
configuration (examples/amcl_3d.yaml).

Run:  python examples/demo_node_3d.py [--steps N] [--platform cpu]
"""

import argparse
import math
import os
import sys
import tempfile

import numpy as np


def _voxel_world(size=10.0, res=0.1, height=1.2, seed=7):
    pts = []
    n = int(size / res)
    nz = int(height / res)
    rng = np.random.default_rng(seed)
    for k in range(nz):
        z = (k + 0.5) * res
        for i in range(n):
            x = (i + 0.5) * res
            pts += [[x, 0.5 * res, z], [x, size - 0.5 * res, z]]
            pts += [[0.5 * res, x, z], [size - 0.5 * res, x, z]]
    for _ in range(10):
        cx, cy = rng.uniform(1.5, size - 1.5, 2)
        for k in range(nz):
            pts.append([cx, cy, (k + 0.5) * res])
    return np.array(pts), res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None,
                    help="JAX platform; default: the accelerator if present")
    ap.add_argument("--steps", type=int, default=50)
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from badger_amcl.cli import load_config
    from badger_amcl.maps.octree_io import read_bt, write_bt
    from badger_amcl.node import make_node
    from badger_amcl.node.messages import OctomapMsg
    from badger_amcl.sim import Sim3D

    pts, res = _voxel_world()

    # exercise the binary octree IO path end to end
    bt_path = os.path.join(tempfile.gettempdir(), "demo_world.bt")
    write_bt(bt_path, res, pts[:: max(1, len(pts) // 4000)])  # thinned for speed
    tree = read_bt(bt_path)
    print(f"octree: wrote+read {len(tree.occupied_voxel_keys())} voxels via {bt_path}")

    cfg = load_config(os.path.join(os.path.dirname(__file__), "amcl_3d.yaml"))
    cfg = cfg.replace(max_particles=2000, min_particles=300,
                      update_min_d=0.05, update_min_a=0.05)
    sim = Sim3D(pts, res, start_pose=(3.0, 3.0, 0.5), n_points=256,
                base_frame=cfg.base_frame_id)
    node = make_node(cfg, tf_buffer=sim.tf)
    node.init_pose = sim.true_pose.copy()
    node.init_cov = np.array([0.2, 0.2, 0.05])
    node.octomap_msg_received(OctomapMsg(resolution=res, occupied_centers=pts))
    print(f"voxel EDT baked: {node.map.distances_u8.shape} cells, "
          f"LUT debug cloud: {len(node.map.distances_lut_cloud(10000))} pts")

    for step in range(args.steps):
        odom = sim.step(0.25, 0.2)
        node.integrate_odom(odom)
        node.scan_received(sim.make_cloud())
        node.spin_once(sim.t)
        if step % 10 == 9:
            _, est = node.get_max_weight_pose()
            exy = math.hypot(est[0] - sim.true_pose[0], est[1] - sim.true_pose[1])
            print(f"step {step:>3}: est=({est[0]:.2f},{est[1]:.2f}) "
                  f"true=({sim.true_pose[0]:.2f},{sim.true_pose[1]:.2f}) "
                  f"err={exy:.3f} n={int(node.state.n_active)}")

    _, est = node.get_max_weight_pose()
    exy = math.hypot(est[0] - sim.true_pose[0], est[1] - sim.true_pose[1])
    eth = abs(math.remainder(est[2] - sim.true_pose[2], 2 * math.pi))
    print(f"\nfinal: err_xy={exy:.3f} m err_th={eth:.3f} rad")
    ok = exy < 0.3 and eth < 0.25
    print("LOCALIZED" if ok else "LOST")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
