"""Info-pkl -> COCO 2D instances json, for pretraining/evaluating the 2D
proposal head standalone (the twin of ``tools/info2coco.py``, without jax;
reference: tools/data_converter/info2coco.py:90-193).

Differences from the reference, on purpose:
  * file_name is each camera's own fpath (the reference reads
    'ring_rear_left' for every camera — info2coco.py:108 — a bug);
  * bbox is standard COCO [x_top_left, y_top_left, w, h] (the reference
    writes [center_x, center_y, w, h] — :135-143);
  * no megvii nori storage ids; width/height are read per camera when the
    image size is not the AV2 default.

    python -m far3d_tpu_torch.cli.info2coco \
        --ann-file data/av2/av2_train_infos.pkl \
        --out data/av2/argo2d_instances_train.json
"""

from __future__ import annotations

import argparse
import json
import pickle
from pathlib import Path

from ..config import AV2_CLASS_NAMES


def convert(infos, class_names, default_sizes=None):
    """infos -> (images, annotations, categories). Pure, unit-testable."""
    images, annotations = [], []
    image_id = 0
    annotation_id = 0
    for info in infos:
        gt2d = info.get('gt2d_infos')
        if gt2d is None:
            continue
        cam_names = list(info['cam_infos'].keys())
        for jth, cam_name in enumerate(cam_names):
            cam = info['cam_infos'][cam_name]
            if default_sizes and cam_name in default_sizes:
                width, height = default_sizes[cam_name]
            else:
                # AV2: ring_front_center is portrait 1550x2048, rest 2048x1550
                portrait = 'front_center' in cam_name
                width, height = (1550, 2048) if portrait else (2048, 1550)
            images.append({'id': image_id, 'file_name': str(cam['fpath']),
                           'width': int(width), 'height': int(height)})
            boxes = gt2d['gt_2dbboxes'][jth]
            labels = gt2d['gt_2dlabels'][jth]
            for kth in range(len(labels)):
                x0, y0, x1, y1 = (float(v) for v in boxes[kth][:4])
                w, h = x1 - x0, y1 - y0
                annotations.append({
                    'id': annotation_id, 'image_id': image_id,
                    'category_id': int(labels[kth]),
                    'bbox': [x0, y0, w, h], 'area': w * h, 'iscrowd': 0})
                annotation_id += 1
            image_id += 1
    categories = [{'id': i, 'name': n} for i, n in enumerate(class_names)]
    return images, annotations, categories


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--ann-file', required=True)
    p.add_argument('--out', required=True)
    args = p.parse_args(argv)
    with open(args.ann_file, 'rb') as f:
        data = pickle.load(f)
    images, annotations, categories = convert(data['infos'], AV2_CLASS_NAMES)
    coco = {
        'info': {'description': 'Argoverse2 2D', 'version': '1.0'},
        'licenses': [], 'images': images, 'annotations': annotations,
        'categories': categories,
    }
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(coco, f)
    print(f'{len(images)} images, {len(annotations)} annotations '
          f'-> {args.out}')


if __name__ == '__main__':
    main()
