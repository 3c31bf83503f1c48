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
import sys
from collections.abc import Mapping
from datetime import datetime
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


def subdir():
    """Timestamped run-directory name, ``%Y%m%d-%H%M%S``."""
    return datetime.now().strftime('%Y%m%d-%H%M%S')


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
    """The config and the revision in `logdir`, by rank 0 of a process
    group (the only process without one)."""
    from facenet_tpu_torch import ioutils
    from facenet_tpu_torch.parallel.mesh import world
    if world()[1] != 0:
        return
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


def embeddings(app_file_name, options):
    """Config for the embeddings app: output ``<dataset>_<model
    stem>/embeddings<suffix>`` (suffix .h5, .npz or .tfrecord) and
    ``log.txt`` beside it, seeded RNGs, provenance written."""
    cfg = load_config(app_file_name, options)

    if not cfg.model.path:
        cfg.model.path = default_model_path

    if cfg.suffix not in ('.h5', '.tfrecord', '.npz'):
        raise ValueError('Invalid suffix for output file, must be h5, npz or tfrecord.')

    cfg.outdir = Path(str(cfg.dataset.path) + '_' + Path(str(cfg.model.path)).stem).expanduser()
    cfg.logdir = cfg.outdir
    cfg.logfile = cfg.outdir.joinpath('log.txt')
    cfg.outfile = cfg.outdir.joinpath('embeddings').with_suffix(cfg.suffix)

    cfg.seed_key = set_seed(cfg.seed)
    _write_provenance(cfg, cfg.logdir, app_file_name)
    return cfg


def validate_on_lfw(app_file_name, options):
    """Config for the fixed-pairs (LFW protocol) validation app:
    ``dataset.path`` and ``dataset.pairs`` expanded (the pairs file
    defaults to ``<dataset parent>/pairs.txt``), log file
    ``<dataset>_<model stem>/validate_on_lfw.txt``, seeded RNGs, provenance
    written."""
    cfg = load_config(app_file_name, options)

    if not cfg.model.path:
        cfg.model.path = default_model_path
    cfg.dataset.path = Path(str(cfg.dataset.path)).expanduser()
    if not cfg.dataset.pairs:
        cfg.dataset.pairs = cfg.dataset.path.parent / 'pairs.txt'
    else:
        cfg.dataset.pairs = Path(str(cfg.dataset.pairs)).expanduser()

    cfg.outdir = Path(str(cfg.dataset.path) + '_'
                      + Path(str(cfg.model.path)).stem).expanduser()
    cfg.logdir = cfg.outdir
    cfg.logfile = cfg.outdir.joinpath('validate_on_lfw.txt')

    cfg.seed_key = set_seed(cfg.seed)
    _write_provenance(cfg, cfg.logdir, app_file_name)
    return cfg


def train_softmax(options, app_file_name=None, run_name=None):
    """Config for the train_softmax app: the run directory
    ``<model.path>/<run_name>`` (default a timestamp) with ``logs/``
    inside, ``model.checkpoint`` expanded, ``train.epoch.max_nrof_epochs``
    defaulting to the last schedule row's epoch, the validation batch size
    and image settings taken from the training ones, seeded RNGs,
    provenance written."""
    app_file_name = app_file_name or sys.argv[0]
    cfg = load_config(app_file_name, options)

    path = Path(str(cfg.model.path)).expanduser()
    cfg.model.path = path / (run_name or subdir())

    cfg.logs = Config()
    cfg.logs.dir = cfg.model.path / 'logs'
    cfg.logs.file = cfg.model.path.stem + '.log'

    if cfg.model.checkpoint:
        cfg.model.checkpoint = Path(str(cfg.model.checkpoint)).expanduser()

    if not cfg.train.epoch.max_nrof_epochs:
        cfg.train.epoch.max_nrof_epochs = cfg.train.learning_rate.schedule[-1][0]

    if cfg.validate:
        cfg.validate.batch_size = cfg.batch_size
        cfg.validate.image.size = cfg.image.size
        cfg.validate.image.normalization = cfg.image.normalization

    cfg.seed_key = set_seed(cfg.seed)
    _write_provenance(cfg, cfg.logs.dir, app_file_name)
    return cfg


def distributed_options(section):
    """`parallel.mesh.init_distributed`'s keyword arguments from a
    ``distributed:`` section (the JAX package's keys); empty keys are left
    to its defaults."""
    keys = ('coordinator_address', 'num_processes', 'process_id',
            'platform')
    values = {k: value_or(getattr(section, k), None) for k in keys}
    return {k: v for k, v in values.items() if v is not None}


def train_softmax_distributed(options, app_file_name=None, device=None):
    """Config and device for the distributed train app: the process group
    comes up first, from the ``distributed:`` section (or torchrun's
    environment), before any CUDA work; then `train_softmax`'s config with
    one run directory for every rank (rank 0's timestamp) and the
    provenance written by rank 0.

    :param device: 'cuda' (default) or 'cpu' (``distributed.platform:
        cpu`` says the same)
    :return: (cfg, this process's device)
    """
    from facenet_tpu_torch.parallel import mesh

    app_file_name = app_file_name or sys.argv[0]
    raw = load_config(app_file_name, options)
    device = mesh.init_distributed(
        device=device, **distributed_options(raw.distributed))
    run_name = mesh.broadcast_object(subdir())
    cfg = train_softmax(options, app_file_name, run_name=run_name)
    return cfg, device


def train_classifier(app_file_name, options):
    """Config for the train_classifier app: the run directory
    ``<classifier.path>/<timestamp>`` holding ``log.txt``, seeded RNGs,
    provenance written."""
    cfg = load_config(app_file_name, options)

    cfg.classifier.path = Path(str(cfg.classifier.path)).expanduser() / subdir()
    cfg.logdir = cfg.classifier.path
    cfg.logfile = cfg.logdir / 'log.txt'

    cfg.seed_key = set_seed(cfg.seed)
    _write_provenance(cfg, cfg.logdir, app_file_name)
    return cfg


def train_detector(options, app_file_name=None):
    """Config for the train_detector app: the run directory
    ``<model.path>/<timestamp>`` with ``logs/`` inside, seeded RNGs,
    provenance written."""
    app_file_name = app_file_name or sys.argv[0]
    cfg = load_config(app_file_name, options)

    path = Path(str(cfg.model.path)).expanduser()
    cfg.model.path = path / subdir()

    cfg.logs = Config()
    cfg.logs.dir = cfg.model.path / 'logs'
    cfg.logs.file = cfg.model.path.stem + '.log'

    cfg.seed_key = set_seed(cfg.seed)
    _write_provenance(cfg, cfg.logs.dir, app_file_name)
    return cfg
