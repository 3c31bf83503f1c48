"""Softmax training over a process grid: one process a card.

The counterpart of the reference's apps/train_softmax_tf2_gpus.py, which
wraps the training flow in a MirroredStrategy: the same flow as
train_softmax (`run`), on the ``mesh:`` grid of the processes
(facenet_tpu_torch/parallel/mesh.py): the global batch split over 'data',
the identity-logits head's columns over 'model', the collectives over NCCL.
The process group comes up first, from torchrun's environment or the
``distributed:`` section (coordinator_address, num_processes, process_id;
``platform: cpu`` runs on the CPU over gloo), before any CUDA work.

    torchrun --nproc-per-node N -m facenet_tpu_torch.apps.train_softmax_distributed --config my.yaml
    python -m facenet_tpu_torch.apps.train_softmax_distributed --config my.yaml [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch
import torch.distributed as dist

from facenet_tpu_torch import config
from facenet_tpu_torch.apps.train_softmax import run


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--config', dest='config_file', default=None,
                        type=Path,
                        help='User yaml config merged on top of the app '
                             'defaults.')
    parser.add_argument('--device', default=None,
                        help="torch device, 'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)

    cfg, device = config.train_softmax_distributed(
        {'config': args.config_file}, app_file_name=__file__,
        device=args.device)
    try:
        local = torch.cuda.device_count() if device.type == 'cuda' else 1
        print(f'devices: {dist.get_world_size()} ({local} local, process '
              f'{dist.get_rank()}/{dist.get_world_size()}) on {device}')
        return run(cfg, device)
    finally:
        dist.destroy_process_group()


if __name__ == '__main__':
    main()
