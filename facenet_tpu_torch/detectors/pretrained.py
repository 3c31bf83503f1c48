"""Bundled detector weights: npz (de)serialization and default lookup.

The repository commits a small MTCNN weight bundle trained on the
synthetic face dataset, so `FaceDetector()` detects faces out of the box.
``weights/mtcnn_synthetic.npz`` is a byte-identical copy of the JAX
package's bundle, so both packages compute with the same parameters.

Format: flat npz — nested param-dict keys joined with '/', values raw
arrays (float16 for repository size). No pickle.
"""

from __future__ import annotations

from collections.abc import Mapping
from pathlib import Path

import numpy as np

PRETRAINED_DIR = Path(__file__).parent / 'weights'

# detector name -> bundled file
BUNDLED = {
    'mtcnn': 'mtcnn_synthetic.npz',
    'pypimtcnn': 'mtcnn_synthetic.npz',
}


def load_params(path):
    """Read a flat npz into a nested param dict of numpy arrays."""
    out = {}
    with np.load(Path(str(path)).expanduser(), allow_pickle=False) as z:
        for key in z.files:
            node = out
            parts = key.split('/')
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return out


def bundled_path(detector):
    """Path of the committed weight bundle for `detector` (or None)."""
    name = BUNDLED.get(str(detector))
    if name is None:
        return None
    path = PRETRAINED_DIR / name
    return path if path.exists() else None


def _cast(tree, dtype):
    if isinstance(tree, Mapping):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return np.asarray(tree, dtype)


def load_bundled(detector, dtype=np.float32):
    """The committed bundle for `detector` as float32 arrays, or None if
    none is shipped (bundles are stored float16)."""
    path = bundled_path(detector)
    return _cast(load_params(path), dtype) if path is not None else None
