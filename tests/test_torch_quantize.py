"""Port int8 serving (models/quantize.py, ops/int8_conv.py) == the JAX
package's (facenet_tpu.models.quantize) on the same weights.

Both packages get the port's `init_variables` trees (TINY IRv1 and TINY
IRv2) with BatchNorm statistics drawn from a numpy seed (mean N(0, 0.1), var
U(0.5, 1.5)), so every conv sees a live input, and the same seeded uint8
images. Bounds:
- calibration absmax: relative 2^-6, two bf16 steps (measured at most
  0.0074 on both families, one step: the packages' bf16 activations differ
  by rounding);
- the quantized tree from the same absmax: bit for bit;
- int8 sums against ``lax.conv_general_dilated(int8, int8 -> int32)``:
  exact, through the GEMM path (``torch._int_mm`` on the CPU) and the plain
  version;
- the int8 forward on JAX's quantized tree carried across, against JAX's
  int8 forward: min cosine >= 0.999;
- int8 against bf16: min cosine > 0.95 (tests/test_quantize.py's bound).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facenet_tpu import FaceNet as JaxFaceNet
from facenet_tpu import export as jax_export
from facenet_tpu.models import irv1_fast as jax_fast1
from facenet_tpu.models import irv2_fast as jax_fast2
from facenet_tpu.models import quantize as jax_quantize
from facenet_tpu.models.inception_resnet_v1 import \
    InceptionResnetV1 as JaxIRv1
from facenet_tpu_torch import FaceNet
from facenet_tpu_torch.config import Config
from facenet_tpu_torch.models import irv1_fast, irv2_fast, quantize
from facenet_tpu_torch.models.inception_resnet_v1 import \
    init_variables as init_v1
from facenet_tpu_torch.models.inception_resnet_v2 import \
    init_variables as init_v2
from facenet_tpu_torch.ops.int8_conv import (int8_sums, int8_sums_plain,
                                             kernel_oihw, quantized_entry)
from torch_testing import few_threads  # noqa: F401

TINY = {'block35': {'repeat': 1}, 'block17': {'repeat': 1},
        'block8_1': {'repeat': 1}, 'output': {'size': 32}}
TINY2 = {'repeat': [1, 1, 1], 'embedding_size': 64}
FAMILIES = {'irv1': (TINY, init_v1, irv1_fast, jax_fast1,
                     irv1_fast.FastEmbedder),
            'irv2': (TINY2, init_v2, irv2_fast, jax_fast2,
                     irv2_fast.FastEmbedderV2)}
ABSMAX_RTOL = 2.0 ** -6


def live_variables(init, config, seed=0):
    variables = init(config, seed=seed)
    rng = np.random.RandomState(seed + 1)

    def stats(path, a):
        if path[-1].key == 'mean':
            return rng.normal(0, 0.1, a.shape).astype(np.float32)
        return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)

    variables['batch_stats'] = jax.tree_util.tree_map_with_path(
        stats, variables['batch_stats'])
    return variables


@pytest.fixture(scope='module')
def images():
    return np.random.RandomState(7).randint(0, 256, (8, 160, 160, 3),
                                            dtype=np.uint8)


@pytest.fixture(scope='module')
def setups(images):
    """family -> its weights, both packages' fast params and both
    calibrations on images[:4], made once."""
    @functools.cache
    def setup(family):
        config, init, fast, jax_fast, _ = FAMILIES[family]
        variables = live_variables(init, config)
        jax_params, cfg = jax_fast.build_fast_params(variables, config)
        params, _ = fast.build_fast_params(variables, config, device='cpu')
        return {
            'variables': variables, 'cfg': cfg, 'params': params,
            'jax_params': jax_params,
            'absmax': quantize.calibrate(params, cfg, images[:4],
                                         forward=fast.fast_forward),
            'jax_absmax': jax_quantize.calibrate(
                jax_params, cfg, images[:4], forward=jax_fast.fast_forward)}
    return setup


def jax_quantized(setup, absmax, skip, monkeypatch, images):
    """JAX's quantize_fast_params with its calibration replaced by
    `absmax`."""
    monkeypatch.setattr(jax_quantize, 'calibrate',
                        lambda *args, **kwargs: dict(absmax))
    forward = (jax_fast2.fast_forward if 'Mixed_5a' in setup['params']
               else None)
    return jax_quantize.quantize_fast_params(
        setup['jax_params'], setup['cfg'], images[:4], skip=skip,
        forward=forward)


@pytest.mark.parametrize('family', FAMILIES)
def test_calibration_covers_every_conv(setups, family):
    s = setups(family)
    tags = {'/'.join(p) for p, _ in quantize._walk_convs(s['params'])}
    # IRv1's serving path runs the space-to-depth form of its first conv;
    # the bottleneck is a plain dot, not a conv
    unused = {'Bottleneck'} | ({'Conv2d_1a_3x3'} if family == 'irv1'
                               else set())
    assert set(s['absmax']) == tags - unused == set(s['jax_absmax'])
    assert all(v > 0 for v in s['absmax'].values())
    assert all('tag' not in w for _, w in quantize._walk_convs(s['params']))
    worst = max(abs(s['absmax'][t] - v) / v
                for t, v in s['jax_absmax'].items())
    assert worst <= ABSMAX_RTOL, worst


@pytest.mark.parametrize('family, skip', [
    ('irv1', quantize.DEFAULT_SKIP), ('irv1', irv1_fast.STEM_SKIP),
    ('irv2', quantize.DEFAULT_SKIP)])
def test_quantized_tree_equals_jax_with_same_absmax(setups, family, skip,
                                                    monkeypatch, images):
    s = setups(family)
    ref = jax_quantized(s, s['absmax'], skip, monkeypatch, images)
    got = quantize.quantize_params(s['params'], s['absmax'], skip)
    ref_entries, got_entries = dict(entries(ref)), dict(entries(got))
    assert set(ref_entries) == set(got_entries)
    quantized = 0
    for path, w in got_entries.items():
        r = ref_entries[path]
        assert ('kq' in w) == ('kq' in r), path
        if 'kq' not in w:
            continue
        hwio = kernel_oihw(w).numpy().transpose(2, 3, 1, 0)
        assert np.array_equal(hwio, np.asarray(r['kq'])), path
        assert np.array_equal(w['ws'].numpy(), np.asarray(r['ws'])), path
        assert w['xs'].numpy() == np.asarray(r['xs']), path
        assert np.array_equal(w['b'].numpy(), np.asarray(r['b'])), path
        quantized += 1
    assert quantized == sum(t.split('/')[0] not in skip
                            for t in s['absmax'])


def entries(tree, path=()):
    """(path, entry) for every float or int8 conv entry of a tree."""
    if 'k' in tree or 'kq' in tree:
        yield path, tree
        return
    for name, sub in tree.items():
        yield from entries(sub, path + (name,))


# every int8 conv geometry of full-width IRv1 and IRv2 (chip_smoke.py phase
# 22), at small spatial sizes: (batch, h, w, ic, oc, kh, kw, stride, padding)
SHAPES = {
    '1x1': (2, 17, 17, 320, 96, 1, 1, 1, 'SAME'),
    '3x3 SAME': (2, 17, 17, 32, 48, 3, 3, 1, 'SAME'),
    '3x3 VALID': (2, 19, 19, 32, 32, 3, 3, 1, 'VALID'),
    '3x3 stride 2': (2, 17, 17, 320, 384, 3, 3, 2, 'VALID'),
    '1x7': (2, 8, 8, 128, 160, 1, 7, 1, 'SAME'),
    '7x1': (2, 8, 8, 160, 192, 7, 1, 1, 'SAME'),
    '1x3': (2, 3, 3, 192, 224, 1, 3, 1, 'SAME'),
    '3x1': (2, 3, 3, 224, 256, 3, 1, 1, 'SAME'),
    '5x5': (2, 17, 17, 48, 64, 5, 5, 1, 'SAME'),
    'K=27 stem': (2, 33, 33, 3, 32, 3, 3, 2, 'VALID'),
    '2x2 space-to-depth': (2, 20, 20, 12, 32, 2, 2, 1, 'VALID'),
    '9 rows': (1, 3, 3, 2080, 1536, 1, 1, 1, 'VALID'),
    'K=45 N=12': (2, 5, 5, 5, 12, 3, 3, 1, 'SAME'),
}


@pytest.mark.parametrize('name', SHAPES)
def test_int8_sums_equal_jax_conv(name):
    b, h, w, ic, oc, kh, kw, stride, padding = SHAPES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    x = rng.randint(-127, 128, (b, h, w, ic)).astype(np.int8)
    k = rng.randint(-127, 128, (kh, kw, ic, oc)).astype(np.int8)
    ref = np.asarray(jax.lax.conv_general_dilated(
        x, k, (stride, stride), padding,
        dimension_numbers=('NHWC', 'HWIO', 'NHWC'),
        preferred_element_type=jnp.int32))
    entry = quantized_entry(k.transpose(3, 2, 0, 1), np.ones(oc), 1.0,
                            np.zeros(oc), 'cpu')
    xq = torch.from_numpy(x)
    gemm = int8_sums(xq, entry, stride, padding)
    plain = int8_sums_plain(xq, entry, stride, padding)
    assert gemm.dtype == plain.dtype == torch.int32
    assert np.array_equal(gemm.numpy(), ref)
    assert np.array_equal(plain.numpy(), ref)


@pytest.mark.parametrize('family, stem', [('irv1', 'cudnn'),
                                          ('irv1', 'fused'),
                                          ('irv2', None)])
def test_int8_forward_matches_jax_on_carried_tree(setups, family, stem,
                                                  monkeypatch, images):
    """JAX quantizes (its own calibration); the port runs that tree. The
    fused stem's skip is held with the port's fused stem (its plain version
    here) against JAX's XLA stem on the same bf16 stem weights."""
    s = setups(family)
    _, _, fast, jax_fast, _ = FAMILIES[family]
    skip = irv1_fast.STEM_SKIP if stem == 'fused' else quantize.DEFAULT_SKIP
    tree = jax_quantized(s, s['jax_absmax'], skip, monkeypatch, images)
    cfg = s['cfg']
    ref = np.asarray(jax.jit(
        lambda p, x: jax_fast.fast_forward(p, cfg, x))(tree, images))
    ours = quantize.from_jax_quantized(
        jax.tree_util.tree_map(np.asarray, tree), device='cpu')
    kwargs = {'stem': stem} if stem else {}
    with torch.inference_mode():
        got = fast.fast_forward(ours, cfg, torch.from_numpy(images),
                                **kwargs).numpy()
    assert got.shape == ref.shape
    cos = (got * ref).sum(axis=1)
    assert cos.min() >= 0.999, cos


@pytest.mark.parametrize('family', FAMILIES)
def test_int8_embeddings_close_to_bf16(setups, family, images):
    s = setups(family)
    config, _, _, _, embedder = FAMILIES[family]
    ref = embedder(s['variables'], config, device='cpu')(images).numpy()
    q = embedder(s['variables'], config, device='cpu', quantize='int8',
                 calib_images=images[:4])
    got = q(images).numpy()
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    cos = (got * ref).sum(axis=1)
    assert cos.min() > 0.95, f'int8 drifted: cosine {cos.min():.4f}'
    # the bottleneck stays float; every calibrated conv is int8
    assert 'k' in q.params['Bottleneck'] and 'kq' not in q.params['Bottleneck']
    heads = q.params['Repeat.block35_1']['heads']
    assert heads['kq'].dtype == torch.int8
    assert heads['ws'].shape == (heads['shape'][0],)


def test_fused_stem_keeps_its_convs_in_bf16(setups, images):
    s = setups('irv1')
    q = irv1_fast.FastEmbedder(s['variables'], TINY, device='cpu',
                               stem='fused', quantize='int8',
                               calib_images=images[:4])
    for name in irv1_fast.STEM_SKIP:
        assert 'kq' not in q.params[name], name
    assert 'kq' in q.params['Conv2d_3b_1x1']


@pytest.mark.parametrize('family', FAMILIES)
def test_quantize_mode_errors(setups, family, images):
    s = setups(family)
    config, _, _, _, embedder = FAMILIES[family]
    with pytest.raises(ValueError, match='calib_images'):
        embedder(s['variables'], config, device='cpu', quantize='int8')
    with pytest.raises(ValueError, match='fp4'):
        embedder(s['variables'], config, device='cpu', quantize='fp4',
                 calib_images=images[:4])


@pytest.fixture(scope='module')
def bundle(tmp_path_factory, setups):
    path = tmp_path_factory.mktemp('int8') / 'bundle'
    jax_export.save_model(path, JaxIRv1(config=TINY),
                          setups('irv1')['variables'])
    return path


@pytest.fixture(scope='module')
def calib_dir(tmp_path_factory):
    """Three mixed-size PNGs (tests/test_quantize.py's)."""
    from PIL import Image
    path = tmp_path_factory.mktemp('calib')
    rng = np.random.RandomState(3)
    for i, (h, w) in enumerate([(100, 80), (160, 160), (240, 320)]):
        img = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
        Image.fromarray(img).save(path / f'{i}.png')
    return path


def test_facenet_quantize_from_config(bundle, calib_dir, setups, images):
    variables = setups('irv1')['variables']
    want = irv1_fast.FastEmbedder(
        variables, TINY, device='cpu', quantize='int8',
        calib_images=images[:4])(images).numpy()
    net = FaceNet(Config({'path': str(bundle), 'quantize': 'int8',
                          'calib': images[:4]}), device='cpu')
    np.testing.assert_array_equal(net.evaluate(images), want)

    batch = FaceNet._calib_batch(Config({'calib': str(calib_dir)}), 160)
    assert batch.shape == (3, 160, 160, 3) and batch.dtype == np.uint8
    np.testing.assert_array_equal(batch, JaxFaceNet._calib_batch(
        Config({'calib': str(calib_dir)}), 160))
    from_dir = FaceNet(Config({'path': str(bundle), 'quantize': 'int8',
                               'calib': str(calib_dir)}), device='cpu')
    want = irv1_fast.FastEmbedder(variables, TINY, device='cpu',
                                  quantize='int8',
                                  calib_images=batch)(images).numpy()
    np.testing.assert_array_equal(from_dir.evaluate(images), want)

    for off in (None, False):
        net = FaceNet(Config({'path': str(bundle), 'quantize': off}),
                      device='cpu')
        assert all('kq' not in w for _, w in
                   entries(net._forward.params))
    with pytest.raises(ValueError, match='calib'):
        FaceNet._calib_batch(Config({}), 160)


def test_validate_int8_tool_on_a_synthetic_directory(bundle, tmp_path,
                                                     capsys):
    """The tool's report pair on 4 identities x 6 images (PNG), CPU."""
    from PIL import Image

    from facenet_tpu_torch.tools import validate_int8
    rng = np.random.RandomState(5)
    for c in range(4):
        base = rng.randint(0, 256, (160, 160, 3))
        (tmp_path / f'id_{c}').mkdir()
        for i in range(6):
            img = np.clip(base + rng.randint(-20, 21, base.shape), 0, 255)
            Image.fromarray(img.astype(np.uint8)).save(
                tmp_path / f'id_{c}' / f'{i}.png')
    identical = validate_int8.main([str(bundle), str(tmp_path), '--batch',
                                    '8', '--device', 'cpu'])
    out = capsys.readouterr().out
    assert '==== bf16 ====' in out and '==== int8 ====' in out
    assert out.strip().endswith(f'int8 report identical to bf16: '
                                f'{identical}')
    assert '(24, 32) embeddings' in out
