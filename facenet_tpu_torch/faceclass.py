"""Face-to-face pair classifiers over embedding-pair distances.

Logits are ``alpha * (threshold - distance(x, y))``:

  * `FaceToFaceDistanceClassifier`, for unnormalized embeddings: the
    normalized-embedding distance plus a theta-weighted norm mismatch,
        d = 2 (1 - x^.y^) + theta * (2 (|x| - |y|) / (|x| + |y|))^2
  * `FaceToFaceNormalizedEmbeddingsClassifier`, for normalized embeddings:
        d = 2 (1 - x.y)

The variables are float32 scalar tensors in a dict; `distance`, `__call__`
and `predict` are plain functions of tensors (differentiable through
autograd, given variables that require grad). `from_variables` and
`variables_dict` carry the JAX package's ``variables`` (numpy scalars)
both ways.
"""

from __future__ import annotations

import numpy as np
import torch


def _scalar(value, device=None):
    return torch.tensor(float(value), dtype=torch.float32, device=device)


class _PairClassifier:
    NAMES = ()

    def __init__(self, device=None, **values):
        self.variables = {name: _scalar(values[name], device)
                          for name in self.NAMES}

    @classmethod
    def from_variables(cls, variables, device=None):
        """A classifier holding `variables` ({name: scalar}, numpy or
        tensors, as JAX's ``classifier.variables``)."""
        return cls(device=device, **{k: float(np.asarray(
            v.detach().cpu() if isinstance(v, torch.Tensor) else v))
            for k, v in variables.items()})

    def variables_dict(self):
        """{name: float32 numpy scalar}, the JAX package's layout."""
        return {k: np.float32(v.detach().cpu().item())
                for k, v in self.variables.items()}

    def __call__(self, x, y=None, variables=None):
        v = variables if variables is not None else self.variables
        return v['alpha'] * (v['threshold'] - self.distance(x, y,
                                                            variables=v))

    def __repr__(self):
        variables = {k: float(v) for k, v in self.variables.items()}
        return (f'{self.__class__.__name__}\n'
                f'variables {variables}\n')

    def variable(self, name, mode=None):
        var = self.variables[name]
        if mode == 'numpy':
            return var.detach().cpu().numpy()
        return var

    def _inputs(self, x, y):
        device = self.variables['alpha'].device
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        y = x if y is None else torch.as_tensor(y, dtype=torch.float32,
                                                device=device)
        return x, y

    def predict(self, x, y=None):
        """[Nx, Ny] bool numpy: distance below the threshold."""
        with torch.no_grad():
            return (self.distance(x, y) < self.variables['threshold']
                    ).cpu().numpy()


class FaceToFaceDistanceClassifier(_PairClassifier):
    """Pair classifier over unnormalized-embedding distances."""

    NAMES = ('alpha', 'threshold', 'theta')

    def __init__(self, alpha=10.0, threshold=1.0, theta=1.0, device=None):
        super().__init__(device, alpha=alpha, threshold=threshold,
                         theta=theta)

    def distance(self, x, y=None, variables=None):
        v = variables if variables is not None else self.variables
        x, y = self._inputs(x, y)
        norm_x = torch.linalg.vector_norm(x, dim=1, keepdim=True)
        norm_y = torch.linalg.vector_norm(y, dim=1, keepdim=True).T
        cos = (x / norm_x) @ (y / norm_y.T).T
        return 2 * (1 - cos) + v['theta'] * torch.square(
            2 * (norm_x - norm_y) / (norm_x + norm_y))


class FaceToFaceNormalizedEmbeddingsClassifier(_PairClassifier):
    """Pair classifier over normalized-embedding distances."""

    NAMES = ('alpha', 'threshold')

    def __init__(self, alpha=10.0, threshold=1.0, device=None):
        super().__init__(device, alpha=alpha, threshold=threshold)

    def distance(self, x, y=None, variables=None):
        x, y = self._inputs(x, y)
        return 2 * (1 - x @ y.T)
