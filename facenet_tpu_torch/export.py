"""Model bundles in the JAX package's format, the compiled serving
artifact, and the per-layer activation dump.

A bundle is a directory:

    <path>/
      model.yaml        — architecture config + image preprocessing contract
      params.msgpack    — flax-serialized {params, batch_stats}

``params.msgpack`` is read and written with this module's own codec of
flax's msgpack format: a nested map of names whose array leaves are msgpack
ext type 1 (3 for numpy scalars) holding a msgpack ``(shape, dtype name,
C-order bytes)`` triple; arrays above 1 GiB are split into
``__msgpack_chunked_array__`` maps (read only: the writer refuses such an
array). ``yaml`` is imported only to read ``model.yaml``; `save_model`
writes it with `config._yaml_lines`, so exporting needs no yaml. Both
packages load a bundle either of them wrote.

`save_compiled` writes ``<path>/model.pt2``, the `torch.export` program of
the fused serving forward that `export_program` makes (the counterpart of
the JAX package's StableHLO ``model.stablehlo``): uint8 [B, H, W, 3] in,
L2-normalized float32 [B, D] out, the weights inside, the batch symbolic;
`load_compiled` runs it,
and ``torch.export.load`` alone runs it without this package. `export_h5`
dumps every layer's activations and every weight under the JAX package's
names.
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path

import numpy as np

MODEL_FILE = 'model.yaml'
PARAMS_FILE = 'params.msgpack'
COMPILED_FILE = 'model.pt2'

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


@dataclasses.dataclass
class ModelBundle:
    """Variables (flax layout, numpy leaves) and the bundle's metadata."""
    variables: dict
    meta: dict

    @property
    def model_class(self):
        return self.meta.get('model_class', 'InceptionResnetV1')

    @property
    def config(self):
        return self.meta.get('config')

    @property
    def image_size(self):
        return int(self.meta.get('image_size', 160))

    @property
    def normalization(self):
        return int(self.meta.get('normalization', 0))


class _Reader:
    """A minimal msgpack decoder over one bytes buffer."""

    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n):
        chunk = self.data[self.pos:self.pos + n]
        if len(chunk) != n:
            raise ValueError('truncated msgpack data')
        self.pos += n
        return chunk

    def unpack(self, fmt):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def value(self):
        b = self.unpack('>B')
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return bytes(self.take(b & 0x1f)).decode('utf-8')
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        sized = {0xc4: '>B', 0xc5: '>H', 0xc6: '>I'}           # bin
        if b in sized:
            return bytes(self.take(self.unpack(sized[b])))
        sized = {0xd9: '>B', 0xda: '>H', 0xdb: '>I'}           # str
        if b in sized:
            return bytes(self.take(self.unpack(sized[b]))).decode('utf-8')
        numbers = {0xca: '>f', 0xcb: '>d', 0xcc: '>B', 0xcd: '>H',
                   0xce: '>I', 0xcf: '>Q', 0xd0: '>b', 0xd1: '>h',
                   0xd2: '>i', 0xd3: '>q'}
        if b in numbers:
            return self.unpack(numbers[b])
        if b in (0xdc, 0xdd):
            return self.array(self.unpack('>H' if b == 0xdc else '>I'))
        if b in (0xde, 0xdf):
            return self.map(self.unpack('>H' if b == 0xde else '>I'))
        fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if b in fixext:
            code = self.unpack('>b')
            return _ext(code, self.take(fixext[b]))
        sized = {0xc7: '>B', 0xc8: '>H', 0xc9: '>I'}           # ext
        if b in sized:
            n = self.unpack(sized[b])
            code = self.unpack('>b')
            return _ext(code, self.take(n))
        raise ValueError(f'unsupported msgpack type byte 0x{b:02x}')

    def array(self, n):
        return [self.value() for _ in range(n)]

    def map(self, n):
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def _ext(code, payload):
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise ValueError(f'unsupported msgpack ext type {code}')
    shape, dtype_name, buffer = _Reader(payload).value()
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if dtype_name == 'bfloat16':
        # widen bf16 bit patterns to float32 (bf16 is the top half)
        bits = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
        arr = bits.view(np.float32)
    else:
        arr = np.frombuffer(buffer, np.dtype(dtype_name)).copy()
    arr = arr.reshape(shape)
    return arr[()] if code == _EXT_NPSCALAR else arr


def _unchunk(tree):
    """Reassemble flax's chunked array leaves in a decoded tree."""
    if not isinstance(tree, dict):
        return tree
    if tree.get('__msgpack_chunked_array__'):
        shape = tuple(tree['shape'][str(i)] for i in range(len(tree['shape'])))
        chunks = [tree['chunks'][str(i)] for i in range(len(tree['chunks']))]
        return np.concatenate(chunks).reshape(shape)
    return {key: _unchunk(value) for key, value in tree.items()}


def msgpack_restore(data):
    """Decode flax msgpack bytes into a nested dict of numpy arrays."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError('trailing bytes after the msgpack object')
    return _unchunk(tree)


def _pack(obj, out):
    """Append the msgpack encoding of `obj` (dict, list, str, bytes,
    non-negative int or numpy array: what a flax tree of arrays holds) to
    `out`."""
    def sized(value, codes):
        for code, fmt in codes:
            if value < 1 << (8 * struct.calcsize(fmt)):
                out.extend(struct.pack('>B' + fmt[1:], code, value))
                return
        raise ValueError(f'msgpack object of size {value} is too large')

    if isinstance(obj, dict):
        if len(obj) < 16:
            out.append(0x80 | len(obj))
        else:
            sized(len(obj), ((0xde, '>H'), (0xdf, '>I')))
        for key, value in obj.items():
            _pack(str(key), out)
            _pack(value, out)
    elif isinstance(obj, (list, tuple)):
        if len(obj) < 16:
            out.append(0x90 | len(obj))
        else:
            sized(len(obj), ((0xdc, '>H'), (0xdd, '>I')))
        for value in obj:
            _pack(value, out)
    elif isinstance(obj, str):
        data = obj.encode('utf-8')
        if len(data) < 32:
            out.append(0xa0 | len(data))
        else:
            sized(len(data), ((0xd9, '>B'), (0xda, '>H'), (0xdb, '>I')))
        out.extend(data)
    elif isinstance(obj, bytes):
        sized(len(obj), ((0xc4, '>B'), (0xc5, '>H'), (0xc6, '>I')))
        out.extend(obj)
    elif isinstance(obj, int) and not isinstance(obj, bool) and obj >= 0:
        if obj < 0x80:
            out.append(obj)
        else:
            out.extend(struct.pack('>BQ', 0xcf, obj))
    elif isinstance(obj, np.ndarray):
        if obj.nbytes > 1 << 30:
            raise ValueError('arrays above 1 GiB are not written')
        payload = bytearray()
        _pack([list(obj.shape), obj.dtype.name,
               np.ascontiguousarray(obj).tobytes()], payload)
        fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
        if len(payload) in fixext:
            out.append(fixext[len(payload)])
        else:
            sized(len(payload), ((0xc7, '>B'), (0xc8, '>H'), (0xc9, '>I')))
        out.extend(struct.pack('>b', _EXT_NDARRAY))
        out.extend(payload)
    else:
        raise TypeError(f'cannot msgpack {type(obj).__name__}')


def msgpack_serialize(tree):
    """Encode a nested dict of numpy arrays as flax's msgpack bytes (the
    reverse of `msgpack_restore`)."""
    out = bytearray()
    _pack(tree, out)
    return bytes(out)


def _yaml_nulls(tree):
    """None as the YAML word ``null`` throughout a dict tree, so that
    `config._yaml_lines` writes what yaml reads back as None."""
    if isinstance(tree, dict):
        return {key: _yaml_nulls(value) for key, value in tree.items()}
    return 'null' if tree is None else tree


def save_model(path, model):
    """Write a bundle of the model's current weights that this package and
    the JAX package both load. In a process group rank 0 writes it (the
    backbone is the same on every rank) and the others return at once.

    :param model: an `InceptionResnetV1` or `InceptionResnetV2`; its class
        name, config as given, image size and normalization are recorded
    """
    from facenet_tpu_torch.config import Config, _yaml_lines
    from facenet_tpu_torch.parallel.mesh import world

    path = Path(str(path)).expanduser()
    if world()[1] != 0:
        return path
    path.mkdir(parents=True, exist_ok=True)

    cfg = model.config
    if isinstance(cfg, Config):
        cfg = cfg.as_dict
    elif cfg is not None:
        cfg = dict(cfg)
    meta = {
        'model_class': type(model).__name__,
        'config': cfg,
        'image_size': int(model.image_size),
        'normalization': int(model.normalization),
        'version': 1,
    }
    lines = _yaml_lines(Config(_yaml_nulls(meta)))
    (path / MODEL_FILE).write_text('\n'.join(lines) + '\n')

    (path / PARAMS_FILE).write_bytes(
        msgpack_serialize(model.to_flax_variables()))
    return path


MODEL_CLASSES = ('InceptionResnetV1', 'InceptionResnetV2')


def load_model(path):
    """Load a bundle saved by ``facenet_tpu.export.save_model``.

    :raises NotImplementedError: for a model class other than
        `MODEL_CLASSES`
    """
    import yaml

    path = Path(str(path)).expanduser()
    with (path / MODEL_FILE).open('rt') as f:
        meta = yaml.safe_load(f)

    bundle = ModelBundle(variables={}, meta=meta)
    if bundle.model_class not in MODEL_CLASSES:
        raise NotImplementedError(
            f'{bundle.model_class} bundles are not supported by the PyTorch '
            f'port (only {", ".join(MODEL_CLASSES)})')

    variables = msgpack_restore((path / PARAMS_FILE).read_bytes())
    return ModelBundle(variables=variables, meta=meta)


def _bundle_of(model_or_bundle):
    """A `ModelBundle` of a bundle or of an embedding module's weights."""
    if isinstance(model_or_bundle, ModelBundle):
        return model_or_bundle
    model = model_or_bundle
    return ModelBundle(model.to_flax_variables(), {
        'model_class': type(model).__name__, 'config': model.config,
        'image_size': int(model.image_size),
        'normalization': int(model.normalization)})


def _serving_module(forward, params):
    """An nn.Module running ``forward(params, images)`` whose tensors are
    its buffers, so that `torch.export` keeps them inside the program."""
    import torch

    leaves = []

    def split(tree):
        if isinstance(tree, dict):
            return {k: split(v) for k, v in tree.items()}
        if isinstance(tree, torch.Tensor):
            leaves.append(tree.detach().clone())
            return _Leaf(len(leaves) - 1)
        return tree

    skeleton = split(params)

    class Serving(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for i, leaf in enumerate(leaves):
                self.register_buffer(f'w{i}', leaf)

        def tree(self, node):
            if isinstance(node, dict):
                return {k: self.tree(v) for k, v in node.items()}
            if isinstance(node, _Leaf):
                return getattr(self, f'w{node.index}')
            return node

        def forward(self, images):
            return forward(self.tree(skeleton), images)

    return Serving()


@dataclasses.dataclass(frozen=True)
class _Leaf:
    index: int


def export_program(model_or_bundle, quantize=None, calib_images=None,
                   device=None):
    """The serving forward as a `torch.export` program on `device` (the GPU
    by default; 'cpu' on a box without one): the family's fused forward
    (`irv1_fast` at ``stem='cudnn'``, or `irv2_fast`) in bfloat16, uint8
    [B, H, W, 3] in, L2-normalized float32 [B, D] out, the folded weights
    inside, the batch a symbolic dimension (any batch runs without a new
    export). With ``quantize='int8'`` and `calib_images` (a uint8 batch)
    it is the int8 serving forward, calibrated on them. `save_compiled`
    writes it; ``CompiledModel(program, device)`` runs it.

    :param model_or_bundle: a `ModelBundle` or an InceptionResnetV1/V2
    :raises NotImplementedError: for a model class without a fused forward
        (the JAX package serializes the plain module there; this port has
        no plain export and raises, as it does when the fused path fails)
    """
    import torch
    from torch.export import Dim, export

    from facenet_tpu_torch.device import resolve_device

    bundle = _bundle_of(model_or_bundle)
    device = resolve_device(device)
    size, norm = bundle.image_size, bundle.normalization
    options = {'config': bundle.config, 'image_size': size,
               'normalization': norm, 'device': device,
               'quantize': quantize, 'calib_images': calib_images}
    if bundle.model_class == 'InceptionResnetV1':
        from facenet_tpu_torch.models import irv1_fast as fast
        embedder = fast.FastEmbedder(bundle.variables, stem='cudnn',
                                     **options)

        def forward(params, images):
            return fast.fast_forward(params, embedder.cfg, images, size,
                                     norm, embedder.dtype, stem='cudnn')
    elif bundle.model_class == 'InceptionResnetV2':
        from facenet_tpu_torch.models import irv2_fast as fast
        embedder = fast.FastEmbedderV2(bundle.variables, **options)

        def forward(params, images):
            return fast.fast_forward(params, embedder.cfg, images, size,
                                     norm, embedder.dtype)
    else:
        raise NotImplementedError(
            f'{bundle.model_class} has no fused serving forward to export')

    module = _serving_module(forward, embedder.params)
    example = torch.zeros((2, size, size, 3), dtype=torch.uint8,
                          device=device)
    with torch.inference_mode(False), torch.no_grad():
        return export(module, (example,), dynamic_shapes={
            'images': {0: Dim('batch', min=1, max=1 << 16)}})


def save_compiled(path, model_or_bundle, quantize=None, calib_images=None,
                  device=None):
    """Write `export_program`'s program, traced on `device`, as
    ``<path>/model.pt2`` and return its path. It is stored with its
    weights on the CPU; `load_compiled` moves it to the device it runs
    on."""
    import torch
    from torch.export.passes import move_to_device_pass

    program = move_to_device_pass(
        export_program(model_or_bundle, quantize, calib_images, device),
        'cpu')
    path = Path(str(path)).expanduser()
    path.mkdir(parents=True, exist_ok=True)
    artifact = path / COMPILED_FILE
    torch.export.save(program, str(artifact))
    return artifact


class CompiledModel:
    """A `save_compiled` program loaded on one device (or an
    `export_program` program on its own): callable with a uint8 [B, H, W,
    3] batch (numpy or tensor), returning the [B, D] float32 embeddings as
    a tensor on that device."""

    def __init__(self, program, device):
        self.program = program
        self.device = device
        self._module = program.module()

    @classmethod
    def load(cls, path, device=None):
        """:param device: where the program runs; None is the GPU (raises
            without one), as for every entry point"""
        import torch
        from torch.export.passes import move_to_device_pass

        from facenet_tpu_torch.device import resolve_device

        device = resolve_device(device)
        path = Path(str(path)).expanduser()
        if path.is_dir():
            path = path / COMPILED_FILE
        program = torch.export.load(str(path))
        return cls(move_to_device_pass(program, str(device)), device)

    def __call__(self, images):
        import torch
        images = torch.as_tensor(np.asarray(images, np.uint8)
                                 if not isinstance(images, torch.Tensor)
                                 else images)
        with torch.no_grad():
            return self._module(images.to(self.device, non_blocking=True))

    @property
    def platforms(self):
        return (self.device.type,)

    def graph(self):
        """The exported graph's code as text (the counterpart of the JAX
        package's StableHLO text)."""
        return self.program.graph_module.print_readable(print_output=False)

    def op_histogram(self):
        """Occurrences of each aten op in the exported graph, most frequent
        first ('conv2d', 'relu', ...; the reference's frozen-graph op
        listing)."""
        import torch
        hist = {}
        for node in self.program.graph.nodes:
            if node.op == 'call_function' and isinstance(
                    node.target, torch._ops.OpOverload):
                name = node.target.overloadpacket.__name__
                hist[name] = hist.get(name, 0) + 1
        return dict(sorted(hist.items(), key=lambda kv: -kv[1]))


def load_compiled(path, device=None):
    """Load a program `save_compiled` wrote (`CompiledModel.load`)."""
    return CompiledModel.load(path, device)


def _walk(tree, prefix, sink):
    for key, item in tree.items():
        name = f'{prefix}/{key}' if prefix else str(key)
        if isinstance(item, dict):
            _walk(item, name, sink)
        else:
            sink(name, np.asarray(item))


def export_h5(h5file, model, variables, images):
    """Dump per-layer activations, every weight and BatchNorm statistic
    and the input to an h5 file, under the JAX package's names:
    ``activations/<flax path>/__call__/0`` (each named submodule's output,
    the conv and bn inside each ConvBnRelu and the blocks' own outputs
    included, and the model's output as ``activations/__call__/0``),
    ``weights/<flax path>``, ``batch_stats/<flax path>`` and ``input``.

    `variables` (a flax-layout numpy tree) is loaded into `model` (an
    InceptionResnetV1 or V2 of this package) and the forward runs at
    inference in bfloat16 (the JAX modules' compute dtype) on the model's
    device; activations are written as float32 in NHWC, as the JAX package
    writes them. An Inception-ResNet-v2 dump lacks the JAX module's
    ``dropout`` entry (the identity at inference): the port's network has
    no dropout submodule.
    """
    import torch

    from facenet_tpu_torch import h5utils
    from facenet_tpu_torch.models.inception_resnet_v1 import _Flax

    h5file = Path(str(h5file)).expanduser()
    model.from_flax_variables(variables)
    device = next(model.parameters()).device
    captured, handles = {}, []

    def hook(name):
        def record(module, args, output):
            captured[name] = output.detach()
        return record

    def attach(module, prefix):
        for name, child in module.named_flax_children():
            path = f'{prefix}/{name}' if prefix else name
            handles.append(child.register_forward_hook(hook(path)))
            if isinstance(child, _Flax):
                attach(child, path)

    attach(model, '')
    images = np.asarray(images)
    try:
        with torch.no_grad():
            out = model(torch.from_numpy(images).to(device),
                        dtype=torch.bfloat16)
    finally:
        for handle in handles:
            handle.remove()
    captured[''] = out

    def nhwc(t):
        t = t.float()
        return (t.permute(0, 2, 3, 1) if t.ndim == 4 else t).cpu().numpy()

    for name, value in captured.items():
        key = f'{name}/__call__/0' if name else '__call__/0'
        h5utils.write(h5file, f'activations/{key}', nhwc(value))

    def write(name, arr):
        h5utils.write(h5file, name, arr)

    _walk(variables['params'], 'weights', write)
    _walk(variables['batch_stats'], 'batch_stats', write)
    h5utils.write(h5file, 'input', images)
    return h5file
