"""The model zoo: the embedding network a model config selects.

A model YAML names its network with ``module:`` and its topology with
``config:`` (``configs/inception_resnet_v1.yaml``, ``..._v2.yaml``, the JAX
package's values). `resolve_module` maps the reference's
``facenet.models.<net>``, the JAX package's ``facenet_tpu.models.<net>``
and a bare ``<net>`` to ``facenet_tpu_torch.models.<net>``, so the JAX
package's YAML files load here too; `create_model_from_config` calls that
module's ``create_model``. PyYAML is imported only to read a YAML file.
"""

from __future__ import annotations

import importlib
from pathlib import Path

from facenet_tpu_torch.config import Config

config_dir = Path(__file__).parent / 'configs'

PACKAGE = 'facenet_tpu_torch.models'
_FOREIGN = ('facenet.models.', 'facenet_tpu.models.')


def load_model_config(name_or_path):
    """A model YAML, by zoo name ('inception_resnet_v1') or path."""
    path = Path(str(name_or_path)).expanduser()
    if not path.exists():
        path = config_dir / f'{name_or_path}.yaml'
    if not path.exists():
        raise ValueError(f'unknown model config: {name_or_path}')
    import yaml
    with open(path) as f:
        return Config(yaml.safe_load(f))


def resolve_module(module_name):
    """The port's module for a reference-, JAX- or port-style name."""
    name = str(module_name)
    for prefix in _FOREIGN:
        if name.startswith(prefix):
            name = f'{PACKAGE}.{name[len(prefix):]}'
    if '.' not in name:
        name = f'{PACKAGE}.{name}'
    return importlib.import_module(name)


def create_model_from_config(model_cfg, image_cfg=None, **kwargs):
    """The embedding network a model config selects.

    `model_cfg` is a zoo name or YAML path, or a Config/dict of the
    reference schema ``{'module': ..., 'config': {...}}``, or a bare
    topology dict (its run-directory keys ``path``, ``checkpoint`` and
    ``weights`` dropped), which builds Inception-ResNet-v1 as does no
    config at all. `kwargs` go to the module's ``create_model``
    (``dtype``).
    """
    if isinstance(model_cfg, (str, Path)):
        model_cfg = load_model_config(model_cfg)
    if model_cfg is not None and not isinstance(model_cfg, Config):
        model_cfg = Config(model_cfg)

    module_name = f'{PACKAGE}.inception_resnet_v1'
    net_cfg = None
    if model_cfg:
        if model_cfg.module:
            module_name = str(model_cfg.module)
            net_cfg = model_cfg.config.as_dict if model_cfg.config else None
        elif model_cfg.config:
            net_cfg = model_cfg.config.as_dict
        else:
            net_cfg = {k: v for k, v in model_cfg.as_dict.items()
                       if k not in ('path', 'checkpoint', 'weights')} or None

    module = resolve_module(module_name)
    return module.create_model(model_cfg=net_cfg, image_cfg=image_cfg,
                               **kwargs)
