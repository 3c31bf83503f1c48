"""Print what a model bundle holds: its parameters (name, shape, size) in
sorted-name order and their total; with ``--ops`` the aten op histogram of
the bundle's compiled program (``model.pt2``); with ``--graph`` the graph
of the bundle's eval forward, traced by torch.export at batch 1 (the JAX
package's ``--jaxpr``).

    python -m facenet_tpu_torch.apps.model_info --path <bundle> [--ops] [--graph] [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

from facenet_tpu_torch import export


def parameter_rows(params):
    """(name, shape, size) of every leaf of a flax-layout tree, keys
    sorted at every level (the order of jax's tree_leaves)."""
    rows = []

    def walk(node, prefix):
        for key in sorted(node):
            name = f'{prefix}/{key}' if prefix else str(key)
            if isinstance(node[key], dict):
                walk(node[key], name)
            else:
                shape = tuple(int(n) for n in node[key].shape)
                rows.append((name, shape, int(node[key].size)))

    walk(params, '')
    return rows


def bundle_module(bundle, device='cpu'):
    """The bundle's network as this package's module, weights loaded, in
    eval mode on `device`."""
    from facenet_tpu_torch import models
    from facenet_tpu_torch.config import Config

    module = models.create_model_from_config(
        {'module': ('inception_resnet_v2'
                    if bundle.model_class == 'InceptionResnetV2'
                    else 'inception_resnet_v1'),
         'config': bundle.config},
        image_cfg=Config({'size': bundle.image_size,
                          'normalization': bundle.normalization}))
    return module.from_flax_variables(bundle.variables).eval().to(device)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--path', type=Path, required=True,
                        help='Path to an exported model bundle directory.')
    parser.add_argument('--graph', action='store_true',
                        help='Also print the graph of the eval forward.')
    parser.add_argument('--ops', action='store_true',
                        help='Print the op histogram of the bundle\'s '
                             'model.pt2 (written by export_model).')
    parser.add_argument('--device', default=None,
                        help="torch device, 'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)

    if args.ops:
        compiled = export.load_compiled(args.path, device=args.device)
        print(f'platforms: {", ".join(compiled.platforms)}')
        hist = compiled.op_histogram()
        width = max(len(op) for op in hist)
        for op, count in hist.items():
            print(f'{op:<{width}}  {count:>6}')
        print(f'\ntotal ops: {sum(hist.values())}')
        return hist

    bundle = export.load_model(args.path)

    print(f"model: {bundle.meta.get('model_class')}")
    print(f"image size: {bundle.meta.get('image_size')}  "
          f"normalization: {bundle.meta.get('normalization')}")
    print()

    rows = parameter_rows(bundle.variables['params'])
    total = sum(size for _, _, size in rows)
    width = max(len(r[0]) for r in rows)
    for name, shape, size in rows:
        print(f'{name:<{width}}  {str(shape):<20} {size:>12,}')
    print(f'\ntotal parameters: {total:,}')

    if args.graph:
        import torch

        from facenet_tpu_torch.device import resolve_device
        device = resolve_device(args.device)
        module = bundle_module(bundle, device)
        images = torch.zeros((1, bundle.image_size, bundle.image_size, 3),
                             dtype=torch.uint8, device=device)
        program = torch.export.export(module, (images,))
        print(program.graph_module.print_readable(print_output=False))
    return rows


if __name__ == '__main__':
    main()
