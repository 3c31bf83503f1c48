"""Export a model bundle, or reference-format h5 weights, as a serving
bundle, with the compiled serving program and, on request, a per-layer
activation dump.

``--model-dir`` loads a bundle (re-exports it); ``--import-h5`` instead
imports the reference's folded h5 weights of an Inception-ResNet-v1
(`models.import_weights`). The bundle goes to ``--output``, with
``model.pt2`` (`export.save_compiled`; ``--no-compiled`` skips it) and, with
``--h5``, the activations of a zeros batch and every weight
(`export.export_h5`). A zeros forward checks the result. Runs on the GPU
unless ``--device cpu``.

    python -m facenet_tpu_torch.apps.export_model --model-dir <bundle> --output <dir> [--h5 dump.h5] [--device cpu]
    python -m facenet_tpu_torch.apps.export_model --import-h5 weights.h5 --output <dir>
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from facenet_tpu_torch import export
from facenet_tpu_torch.device import resolve_device


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--model-dir', type=Path, default=None,
                        help='Model bundle directory to load (or re-export).')
    parser.add_argument('--import-h5', dest='import_h5', type=Path,
                        default=None,
                        help='Instead of --model-dir: import reference-schema '
                             'folded h5 weights.')
    parser.add_argument('--image-size', type=int, default=160,
                        help='Input geometry for --import-h5 (default 160).')
    parser.add_argument('--output', type=Path, required=True,
                        help='Output bundle directory.')
    parser.add_argument('--h5', dest='h5file', type=Path, default=None,
                        help='Also dump per-layer activations and weights '
                             'to this h5 file.')
    parser.add_argument('--compiled', dest='compiled', action='store_true',
                        default=True,
                        help='Write the compiled serving program '
                             'model.pt2 (default).')
    parser.add_argument('--no-compiled', dest='compiled',
                        action='store_false')
    parser.add_argument('--device', default=None,
                        help="torch device, 'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    if (args.model_dir is None) == (args.import_h5 is None):
        parser.error('exactly one of --model-dir / --import-h5 is required')
    device = resolve_device(args.device)

    if args.import_h5 is not None:
        from facenet_tpu_torch.models.import_weights import import_h5_weights
        variables = import_h5_weights(args.import_h5,
                                      image_size=args.image_size)
        bundle = export.ModelBundle(variables, {
            'model_class': 'InceptionResnetV1', 'config': None,
            'image_size': args.image_size, 'normalization': 0,
            'source': str(args.import_h5)})
    else:
        bundle = export.load_model(args.model_dir)

    from facenet_tpu_torch import FaceNet
    from facenet_tpu_torch.apps.model_info import bundle_module
    from facenet_tpu_torch.config import Config

    module = bundle_module(bundle)
    path = export.save_model(args.output, module)

    # smoke forward on zeros
    size = bundle.image_size
    images = np.zeros((1, size, size, 3), np.uint8)
    out = FaceNet(Config({}), device=device, bundle=bundle).evaluate(images)
    print(f'smoke forward: input {images.shape} -> output {out.shape}')

    if args.compiled:
        artifact = export.save_compiled(args.output, bundle, device=device)
        compiled = export.load_compiled(artifact, device=device)
        got = compiled(images)
        if tuple(got.shape) != out.shape:
            raise RuntimeError(f'compiled artifact gives {tuple(got.shape)},'
                               f' the bundle {out.shape}')
        print(f'compiled artifact: {artifact} '
              f'(platforms {compiled.platforms})')

    if args.h5file:
        export.export_h5(args.h5file, module.to(device), bundle.variables,
                         images)
        print('activation dump:', args.h5file)

    print('exported to', path)
    return path


if __name__ == '__main__':
    main()
