"""Cascaded-YAML configuration.

The cascade, lowest priority first: package default ``config.yaml`` ->
package per-app yaml -> user ``config.yaml`` -> user per-app yaml ->
``--config`` file. `Config` is an attribute dict whose missing keys return
a falsy empty `Config`, so application code can write ``if cfg.x:`` for
optional settings. ``yaml`` is imported only where a file is read, so the
package imports on a machine without it.
"""

from __future__ import annotations

import random
from collections.abc import Mapping
from pathlib import Path

import numpy as np
import torch

# directory for default configs shipped with the package
default_config_dir = Path(__file__).parents[0].joinpath('apps', 'configs')
default_config = default_config_dir.joinpath('config.yaml')

# directory for user's configs (sibling of the package)
user_config_dir = Path(__file__).parents[1].joinpath('configs')
user_config = user_config_dir.joinpath('config.yaml')

# directory for default trained model
default_model_path = Path(__file__).parents[1].joinpath('models/default')


def config_paths(app_file_name, custom_config_file=None):
    """The config cascade for an app, lowest priority first."""
    config_name = Path(app_file_name).stem + '.yaml'

    paths = [
        default_config,
        default_config_dir.joinpath(config_name),
        user_config,
        user_config_dir.joinpath(config_name),
    ]

    if custom_config_file is not None:
        paths.append(Path(custom_config_file))

    return tuple(paths)


def value_or(value, default):
    """`value` unless it is a *missing* config entry — None, '', or the
    falsy empty Config a missing key yields — else `default`.

    Use this instead of ``value or default`` whenever 0/False are
    legitimate settings.
    """
    if value is None or value == '':
        return default
    if hasattr(value, 'as_dict') and not value:
        return default
    return value


def set_seed(seed):
    """Seed the python/numpy RNGs and return a seeded torch.Generator."""
    seed = int(seed or 0)
    random.seed(seed)
    np.random.seed(seed)
    return torch.Generator().manual_seed(seed)


def _yaml_lines(cfg, depth=0):
    """Render a Config tree as yaml-style ``key: value`` lines."""
    pad = '   ' * depth
    for key, item in cfg.items():
        if isinstance(item, Config):
            yield f'{pad}{key}:'
            yield from _yaml_lines(item, depth + 1)
        else:
            yield f'{pad}{key}: {item}'


class Config:
    """YAML settings as a dict-like object with values as attributes.

    Missing attributes return an *empty, falsy* Config, so
    ``if cfg.optional.nested.value:`` needs no existence checks. Dunder
    probes (copy, pickle, inspect) still see a genuine AttributeError.
    """

    def __init__(self, dct=None):
        if dct:
            self.update(dct)

    def __getattr__(self, name):
        if name.startswith('__') and name.endswith('__'):
            raise AttributeError(name)
        return Config()

    def __repr__(self):
        body = '\n'.join(_yaml_lines(self))
        return body + '\n' if body else ''

    def __bool__(self):
        return bool(self.__dict__)

    def __eq__(self, other):
        if isinstance(other, Config):
            return self.as_dict == other.as_dict
        return NotImplemented

    def __contains__(self, name):
        return name in self.__dict__

    @property
    def as_dict(self):
        return {key: item.as_dict if isinstance(item, Config) else item
                for key, item in self.__dict__.items()}

    def items(self):
        return self.__dict__.items()

    def exists(self, name):
        return name in self.__dict__

    def update(self, dct):
        """Deep-update from a dict or Config."""
        if isinstance(dct, Config):
            dct = dct.as_dict
        for key, item in dct.items():
            current = self.__dict__.get(key)
            if isinstance(item, Mapping) and isinstance(current, Config):
                current.update(item)
            elif isinstance(item, Mapping):
                setattr(self, key, Config(item))
            else:
                setattr(self, key, item)


class LoadConfigError(Exception):
    pass


def _deep_merge(base: dict, extra: dict) -> dict:
    """Recursively merge `extra` on top of `base`."""
    out = dict(base)
    for key, value in extra.items():
        if key in out and isinstance(out[key], dict) and isinstance(value, dict):
            out[key] = _deep_merge(out[key], value)
        else:
            out[key] = value
    return out


def load_config(app_file_name, options=None):
    """Load the merged configuration for an app from the config cascade.

    :param app_file_name: path of the app module (its stem selects per-app yaml)
    :param options: optional dict with a 'config' key pointing at a custom file
    :return: merged Config
    """
    import yaml

    options = options or {}
    paths = config_paths(app_file_name, options.get('config'))

    merged = {}
    loaded_any = False

    for config_path in paths:
        config_path = Path(config_path).expanduser()
        if not config_path.is_file():
            continue
        try:
            with config_path.open('rt') as f:
                new_cfg = yaml.safe_load(f) or {}
            merged = _deep_merge(merged, new_cfg)
            loaded_any = True
        except Exception as err:
            raise LoadConfigError(
                f"Cannot load configuration from '{config_path}'\n{err}")

    if not loaded_any:
        raise LoadConfigError('The configuration has not been loaded.')

    return Config(merged)


def _write_provenance(cfg, logdir, app_file_name):
    from facenet_tpu_torch import ioutils
    ioutils.write_arguments(cfg, Path(logdir) / (Path(app_file_name).stem + '.yaml'))
    ioutils.store_revision_info(logdir)


def validate(app_file_name, options):
    """Config for the validate app: output dir ``<dataset>_<model stem>``,
    log file ``validate.txt``, seeded RNGs, provenance written."""
    cfg = load_config(app_file_name, options)

    if not cfg.model.path:
        cfg.model.path = default_model_path

    cfg.outdir = Path(str(cfg.dataset.path) + '_' + Path(str(cfg.model.path)).stem).expanduser()
    cfg.logdir = cfg.outdir
    cfg.logfile = cfg.outdir.joinpath('validate.txt')

    cfg.seed_key = set_seed(cfg.seed)
    _write_provenance(cfg, cfg.logdir, app_file_name)
    return cfg


def extract_faces(app_file_name, options):
    """Config for the extract_faces app: output dir (default
    ``<dataset>_extracted_<size>``), ``log.txt`` and ``statistics.h5`` in
    it, seeded RNGs, provenance written."""
    cfg = load_config(app_file_name, options)

    if not cfg.outdir:
        cfg.outdir = (f'{Path(str(cfg.dataset.path)).expanduser()}'
                      f'_extracted_{cfg.image.size}')

    cfg.outdir = Path(cfg.outdir).expanduser()
    cfg.logdir = cfg.outdir
    cfg.logfile = cfg.outdir / 'log.txt'
    cfg.h5file = cfg.outdir / 'statistics.h5'

    cfg.seed_key = set_seed(cfg.seed)
    _write_provenance(cfg, cfg.logdir, app_file_name)
    return cfg
