"""Dataset preprocessing: info pickles, the GT database, artifact checks.

Counterpart of the repository's ``tools/create_data.py`` (reference
tools/create_data.py + tools/data_converter/), with the same arguments:

    python -m msmdfusion_torch.tools.create_data nuscenes \\
        --root-path data/nuscenes [--out-dir DIR] [--version v1.0-trainval] \\
        [--max-sweeps 10] [--validate-foreground] [--with-gt-database]

- ``nuscenes``: the info pickles ``nuscenes_infos_{train,val}.pkl`` through
  nuscenes-devkit (``create_nuscenes_infos``), which stops with the tool's
  message where ``nuscenes`` cannot be imported, unless
  ``--with-gt-database`` finds ``nuscenes_infos_train.pkl`` already in the
  output directory: then the database is built from it and no info pickle
  is written;
- ``--with-gt-database``: every GT box's points of the train infos'
  keyframes, box-local, one ``gt_database/<token>_<name>_<i>.bin`` each,
  and their index ``nuscenes_dbinfos_train.pkl``: the file name the
  configs' ``db_sampler`` reads (the repository's tool writes the same
  contents as ``dbinfos_train.pkl``);
- ``--validate-foreground``: the MDU artifacts' layout;
- ``kitti``: refused, as the repository's tool refuses it (the standard
  ``kitti_infos`` pickles of the reference tooling are read as they are).
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import pickle
from typing import List, Optional

import numpy as np

from ..core.box_np_ops import points_in_rbbox_np

DB_INFO_NAME = 'nuscenes_dbinfos_train.pkl'


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description='Create info pickles and the '
                                'GT database')
    p.add_argument('dataset', choices=['nuscenes', 'kitti'])
    p.add_argument('--root-path', default='data/nuscenes')
    p.add_argument('--out-dir', default=None)
    p.add_argument('--version', default='v1.0-trainval')
    p.add_argument('--max-sweeps', type=int, default=10)
    p.add_argument('--validate-foreground', action='store_true',
                   help='check FOREGROUND_MIXED_6NN_WITH_DEPTH artifacts')
    p.add_argument('--with-gt-database', action='store_true')
    return p.parse_args(argv)


def create_nuscenes_infos(root_path, version, max_sweeps):
    try:
        from nuscenes import NuScenes
        from nuscenes.utils import splits
    except ImportError:
        raise SystemExit(
            'nuscenes-devkit is required for info generation; it is not '
            'installed. Pre-built info pickles from the reference pipeline '
            'are drop-in compatible (the reader accepts the standard '
            "'infos' + 'metadata' layout; --with-gt-database builds the "
            'GT database from nuscenes_infos_train.pkl in the output '
            'directory).')
    nusc = NuScenes(version=version, dataroot=root_path, verbose=True)
    train_scenes = set(splits.train if 'trainval' in version
                       else splits.mini_train)
    infos_train, infos_val = [], []
    for sample in nusc.sample:
        scene = nusc.get('scene', sample['scene_token'])['name']
        lidar = nusc.get('sample_data', sample['data']['LIDAR_TOP'])
        cs = nusc.get('calibrated_sensor',
                      lidar['calibrated_sensor_token'])
        pose = nusc.get('ego_pose', lidar['ego_pose_token'])
        info = dict(
            token=sample['token'],
            lidar_path=os.path.join(root_path, lidar['filename']),
            timestamp=sample['timestamp'],
            lidar2ego_rotation=cs['rotation'],
            lidar2ego_translation=cs['translation'],
            ego2global_rotation=pose['rotation'],
            ego2global_translation=pose['translation'],
            sweeps=[], cams={},
        )
        # sweeps
        sd = lidar
        while len(info['sweeps']) < max_sweeps and sd['prev']:
            sd = nusc.get('sample_data', sd['prev'])
            scs = nusc.get('calibrated_sensor',
                           sd['calibrated_sensor_token'])
            info['sweeps'].append(dict(
                data_path=os.path.join(root_path, sd['filename']),
                timestamp=sd['timestamp'],
                sensor2lidar_rotation=np.asarray(
                    _quat_mat(scs['rotation'])),
                sensor2lidar_translation=np.asarray(scs['translation'])))
        # annotations
        boxes, names, vels = [], [], []
        for tok in sample['anns']:
            ann = nusc.get('sample_annotation', tok)
            box = nusc.get_box(tok)
            names.append(_map_name(ann['category_name']))
            vel = nusc.box_velocity(tok)[:2]
            boxes.append(np.concatenate([
                box.center, box.wlh, [box.orientation.yaw_pitch_roll[0]]]))
            vels.append(np.nan_to_num(vel))
        info['gt_boxes'] = np.asarray(boxes, np.float32).reshape(-1, 7)
        info['gt_names'] = np.asarray(names)
        info['gt_velocity'] = np.asarray(vels, np.float32).reshape(-1, 2)
        (infos_train if scene in train_scenes else infos_val).append(info)
    return infos_train, infos_val


NAME_MAP = {
    'vehicle.car': 'car', 'vehicle.truck': 'truck',
    'vehicle.construction': 'construction_vehicle', 'vehicle.bus.bendy':
    'bus', 'vehicle.bus.rigid': 'bus', 'vehicle.trailer': 'trailer',
    'movable_object.barrier': 'barrier', 'vehicle.motorcycle': 'motorcycle',
    'vehicle.bicycle': 'bicycle', 'human.pedestrian.adult': 'pedestrian',
    'human.pedestrian.child': 'pedestrian',
    'human.pedestrian.construction_worker': 'pedestrian',
    'human.pedestrian.police_officer': 'pedestrian',
    'movable_object.trafficcone': 'traffic_cone',
}


def _map_name(cat):
    for prefix, name in NAME_MAP.items():
        if cat.startswith(prefix):
            return name
    return 'ignore'


def _quat_mat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def create_gt_database(root_path, info_path, out_dir, classes):
    """Crop per-GT point clusters (reference create_gt_database.py): each
    box's keyframe points, box-local, in ``out_dir/gt_database``, and their
    index ``out_dir/nuscenes_dbinfos_train.pkl`` ({class: [dict(name,
    path relative to ``out_dir``, box3d_lidar, num_points_in_gt)]});
    returns the index's path."""
    with open(info_path, 'rb') as f:
        data = pickle.load(f)
    infos = data['infos'] if isinstance(data, dict) else data
    db = {c: [] for c in classes}
    db_dir = os.path.join(out_dir, 'gt_database')
    os.makedirs(db_dir, exist_ok=True)
    for info in infos:
        pts = np.fromfile(info['lidar_path'],
                          dtype=np.float32).reshape(-1, 5)
        boxes = np.asarray(info['gt_boxes'])
        inside = points_in_rbbox_np(pts[:, :3], boxes)
        for gi, name in enumerate(info['gt_names']):
            if name not in db:
                continue
            cluster = pts[inside[:, gi]].copy()
            cluster[:, :3] -= boxes[gi, :3]
            fname = f"{info['token']}_{name}_{gi}.bin"
            cluster.tofile(os.path.join(db_dir, fname))
            db[name].append(dict(
                name=name, path=os.path.join('gt_database', fname),
                box3d_lidar=boxes[gi],
                num_points_in_gt=int(inside[:, gi].sum())))
    out = os.path.join(out_dir, DB_INFO_NAME)
    with open(out, 'wb') as f:
        pickle.dump(db, f)
    return out


def validate_foreground_artifacts(root_path: str,
                                  subdir='FOREGROUND_MIXED_6NN_WITH_DEPTH',
                                  max_check: int = 20) -> int:
    """Validate the MDU virtual-point artifact layout the LC pipeline reads.

    The reference treats `FOREGROUND_MIXED_6NN_WITH_DEPTH` as a downloaded
    artifact (README.md:44) — one `<lidar file>.pkl.npy` per keyframe
    holding a dict with per-camera lists:
        virtual_pixel_indices [M, 3+11] (u, v, depth, one-hot label block)
        real_pixel_indices    [Mr, 3+11]
        virtual_points        [M, 3] or [M, 14]
        real_points           [Mr, 3] or [Mr, 14]
    (consumed by datasets/pipelines/foreground.py:LoadForeground2D).
    Returns the number of validated files.
    """
    import glob
    paths = glob.glob(os.path.join(root_path, '**', subdir, '*.pkl.npy'),
                      recursive=True)[:max_check]
    if not paths:
        print(f'no {subdir} artifacts found under {root_path} — the '
              'flagship LC pipeline needs them (see README)')
        return 0
    required = ('virtual_pixel_indices', 'real_pixel_indices',
                'virtual_points', 'real_points')
    for p in paths:
        info = np.load(p, allow_pickle=True).item()
        missing = [k for k in required if k not in info]
        assert not missing, f'{p}: missing keys {missing}'
        n_cam = len(info['virtual_pixel_indices'])
        assert len(info['virtual_points']) == n_cam, p
        for cam in range(n_cam):
            vp = info['virtual_pixel_indices'][cam]
            vpts = info['virtual_points'][cam]
            assert vp.ndim == 2 and vp.shape[1] >= 3, (p, vp.shape)
            assert vpts.shape[0] == vp.shape[0], (p, cam)
    print(f'validated {len(paths)} foreground artifact files '
          f'({n_cam} cameras each)')
    return len(paths)


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the tool; returns dict(infos: the info pickles written,
    validated: the artifact files checked, gt_database: the index's path)
    for callers that run it in-process."""
    args = parse_args(argv)
    out_dir = args.out_dir or args.root_path
    done = dict(infos=[], validated=None, gt_database=None)
    if args.dataset != 'nuscenes':
        raise SystemExit('KITTI info generation expects the standard '
                         'kitti_infos pickles from the reference tooling.')
    train_info = os.path.join(out_dir, 'nuscenes_infos_train.pkl')
    if (importlib.util.find_spec('nuscenes') is not None
            or not (args.with_gt_database and os.path.isfile(train_info))):
        train, val = create_nuscenes_infos(args.root_path, args.version,
                                           args.max_sweeps)
        meta = dict(version=args.version)
        for name, infos in (('train', train), ('val', val)):
            path = os.path.join(out_dir, f'nuscenes_infos_{name}.pkl')
            with open(path, 'wb') as f:
                pickle.dump(dict(infos=infos, metadata=meta), f)
            print(f'wrote {len(infos)} infos to {path}')
            done['infos'].append(path)
    if args.validate_foreground:
        done['validated'] = validate_foreground_artifacts(args.root_path)
    if args.with_gt_database:
        from ..datasets.nuscenes import NuScenesDataset
        done['gt_database'] = create_gt_database(
            args.root_path, train_info, out_dir, NuScenesDataset.CLASSES)
        print(f'wrote GT database to {done["gt_database"]}')
    return done


if __name__ == '__main__':
    main()
