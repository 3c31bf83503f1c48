"""Procedural synthetic faces and scenes: the benchmark's traffic renderer.

Copied from ``facenet_tpu_torch/utils/synthetic.py`` (`identity_params`,
`_hard_identity_params`, the face shader `_ellipse` .. `_paint_face`,
`_background`, `render_face_patch`, `render_scene`), so that a change to
the program cannot change the benchmark's inputs. The same seed gives the
same images as the original. `render_scene` keeps only the 'base' family:
the 'shifted' and 'stress' families of the original are the detector's
held-out evaluation sets, which no cell renders.
"""

from __future__ import annotations

import numpy as np

def identity_params(class_id, salt=0, hard=False):
    """Deterministic appearance parameters for one identity.

    With hard=True, identities are drawn as FAMILY ARCHETYPE + SMALL DELTA
    (VERDICT r2 next #2): ~8 identities share each archetype, so a
    benchmark over hard identities contains many near-identical negative
    pairs — the Bayes rate of the pair task drops below 1.0 no matter how
    strong the embedding model, and the 10-fold accuracy leaves the
    saturated >=0.999 regime. The family hash mixes the id so disjoint
    train/eval id ranges still both form families.
    """
    if hard:
        return _hard_identity_params(class_id, salt)
    rng = np.random.RandomState((1_000_003 * (int(class_id) + 1) + salt)
                                % (2 ** 31))
    skin_base = np.array([225, 185, 150], np.float32)
    return {
        'skin': skin_base * rng.uniform(0.55, 1.05) *
                np.array([1.0, rng.uniform(0.9, 1.05), rng.uniform(0.85, 1.1)],
                         np.float32),
        'face_rx': rng.uniform(0.62, 0.80),     # head half-width
        'face_ry': rng.uniform(0.82, 0.97),     # head half-height
        'eye_dx': rng.uniform(0.24, 0.38),      # eye x offset from center
        'eye_y': rng.uniform(-0.34, -0.16),     # eye row
        'eye_rx': rng.uniform(0.10, 0.16),
        'eye_ry': rng.uniform(0.055, 0.095),
        'iris_r': rng.uniform(0.035, 0.060),
        'iris_col': rng.uniform(20, 110, 3).astype(np.float32),
        'brow_w': rng.uniform(0.02, 0.05),      # brow half-height
        'brow_tilt': rng.uniform(-0.08, 0.08),
        'nose_len': rng.uniform(0.30, 0.48),    # from eye row to tip
        'nose_w': rng.uniform(0.05, 0.11),
        'mouth_y': rng.uniform(0.42, 0.58),
        'mouth_w': rng.uniform(0.18, 0.34),     # mouth half-width
        'mouth_h': rng.uniform(0.035, 0.075),
        'mouth_curve': rng.uniform(-0.06, 0.10),
        'lip_col': np.array([rng.uniform(120, 200), rng.uniform(30, 80),
                             rng.uniform(40, 90)], np.float32),
        'hair_line': rng.uniform(-0.75, -0.45),  # v above which hair covers
        'hair_col': rng.uniform(10, 130, 3).astype(np.float32),
    }


HARD_FAMILY_SIZE = 8        # identities per archetype in hard mode
HARD_DELTA = 0.18           # identity delta as a fraction of the range


def _hard_identity_params(class_id, salt=0):
    """Archetype + delta parameter draw (see identity_params hard=True).

    Scalar parameters move from the family archetype by at most
    HARD_DELTA x their base range; colors by a matching fraction. A family
    is `class_id // HARD_FAMILY_SIZE` (salted), so consecutive ids share
    an archetype.
    """
    family = int(class_id) // HARD_FAMILY_SIZE
    base = identity_params(family * 7_919 + 13, salt=salt + 101)

    rng = np.random.RandomState((2_000_033 * (int(class_id) + 1) + salt)
                                % (2 ** 31))
    # base ranges from the identity_params draw, keyed by parameter
    ranges = {
        'face_rx': 0.18, 'face_ry': 0.15, 'eye_dx': 0.14, 'eye_y': 0.18,
        'eye_rx': 0.06, 'eye_ry': 0.04, 'iris_r': 0.025, 'brow_w': 0.03,
        'brow_tilt': 0.16, 'nose_len': 0.18, 'nose_w': 0.06,
        'mouth_y': 0.16, 'mouth_w': 0.16, 'mouth_h': 0.04,
        'mouth_curve': 0.16, 'hair_line': 0.30,
    }
    p = dict(base)
    for key, width in ranges.items():
        p[key] = float(base[key] + rng.uniform(-1, 1) * width * HARD_DELTA)
    for key in ('skin', 'iris_col', 'lip_col', 'hair_col'):
        p[key] = (base[key] *
                  (1.0 + rng.uniform(-HARD_DELTA * 0.5, HARD_DELTA * 0.5, 3))
                  ).astype(np.float32)
    return p


def _ellipse(u, v, cu, cv, ru, rv):
    return ((u - cu) / ru) ** 2 + ((v - cv) / rv) ** 2 <= 1.0


def _shade_face(u, v, p, light):
    """Evaluate the face at local coords (u, v) -> (rgb float32, head mask).

    `light` in [0.7, 1.3] scales the skin/hair shading (per-image jitter).
    """
    h, w = u.shape
    rgb = np.zeros((h, w, 3), np.float32)

    head = _ellipse(u, v, 0.0, 0.0, p['face_rx'], p['face_ry'])

    # skin with a soft left-right shading gradient
    shade = (1.0 - 0.18 * (u / max(p['face_rx'], 1e-3))) * light
    rgb[head] = p['skin'][None, :] * shade[head, None]

    # hair: top band of the head
    hair = head & (v < p['hair_line'])
    rgb[hair] = p['hair_col'][None, :] * light

    ey, dx = p['eye_y'], p['eye_dx']
    for s in (-1.0, 1.0):
        sclera = _ellipse(u, v, s * dx, ey, p['eye_rx'], p['eye_ry'])
        rgb[sclera & head] = 235.0 * light
        iris = _ellipse(u, v, s * dx, ey, p['iris_r'], p['iris_r'])
        rgb[iris & head] = p['iris_col'][None, :] * 0.9
        # brow: tilted band above the eye
        bv = ey - 2.2 * p['eye_ry'] + p['brow_tilt'] * s * (u - s * dx)
        brow = (np.abs(v - bv) < p['brow_w']) & \
               (np.abs(u - s * dx) < p['eye_rx'] * 1.35)
        rgb[brow & head] = p['hair_col'][None, :] * 0.8

    # nose: narrow triangle from eye row down to the tip, slightly darker
    tip = ey + p['nose_len']
    span = np.clip((v - ey) / max(p['nose_len'], 1e-3), 0.0, 1.0)
    nose = (v >= ey) & (v <= tip) & (np.abs(u) <= p['nose_w'] * span)
    rgb[nose & head] = p['skin'][None, :] * 0.72 * light

    # mouth: curved band
    mv = p['mouth_y'] + p['mouth_curve'] * (u / max(p['mouth_w'], 1e-3)) ** 2
    mouth = (np.abs(v - mv) < p['mouth_h']) & (np.abs(u) < p['mouth_w'])
    rgb[mouth & head] = p['lip_col'][None, :] * light

    return rgb, head


def _face_landmarks_local(p):
    """5-point landmarks in face-local coordinates [(u, v) x 5]."""
    tip = p['eye_y'] + p['nose_len']
    return np.array([
        [-p['eye_dx'], p['eye_y']],
        [p['eye_dx'], p['eye_y']],
        [0.0, tip],
        [-p['mouth_w'] * 0.85, p['mouth_y']],
        [p['mouth_w'] * 0.85, p['mouth_y']],
    ], np.float32)


def _paint_face(img, cx, cy, half, rot, p, light, aspect=1.0):
    """Composite one face into `img` (modified in place).

    :param aspect: horizontal squash (< 1 narrows the face — a cheap yaw
        proxy used by the hard render mode)
    :returns: (tight box [x1, y1, x2, y2], landmarks [5, 2]) in image pixels,
        or None if the face fell fully outside the canvas.
    """
    h, w = img.shape[:2]
    pad = int(np.ceil(half * 1.45))
    x1, x2 = int(cx) - pad, int(cx) + pad
    y1, y2 = int(cy) - pad, int(cy) + pad
    xs1, xs2 = max(x1, 0), min(x2, w)
    ys1, ys2 = max(y1, 0), min(y2, h)
    if xs2 - xs1 < 4 or ys2 - ys1 < 4:
        return None

    yy, xx = np.mgrid[ys1:ys2, xs1:xs2].astype(np.float32)
    c, s = np.cos(rot), np.sin(rot)
    du, dv = (xx - cx) / half, (yy - cy) / half
    u = (c * du + s * dv) / aspect
    v = -s * du + c * dv

    rgb, head = _shade_face(u, v, p, light)
    region = img[ys1:ys2, xs1:xs2]
    region[head] = np.clip(rgb[head], 0, 255).astype(np.uint8)

    if not head.any():
        return None
    ys, xs = np.nonzero(head)
    box = np.array([xs1 + xs.min(), ys1 + ys.min(),
                    xs1 + xs.max() + 1, ys1 + ys.max() + 1], np.float32)

    lm = _face_landmarks_local(p)
    lmu = lm[:, 0] * aspect
    lmx = cx + (c * lmu - s * lm[:, 1]) * half
    lmy = cy + (s * lmu + c * lm[:, 1]) * half
    return box, np.stack([lmx, lmy], axis=1)


def _background(rng, h, w, clutter=True):
    """Gradient + noise background with non-face distractor shapes.

    Distractor species (round 4 adds the skin-toned blob): a featureless
    ellipse, a rectangle, and a SKIN-TONED blob with dark speckles — the
    face-colored decoy that punishes color-only detection. The blob also
    appears in the 'shifted' family; having it in the TRAINING family
    teaches rejection (round-4 stress-mix retraining had pushed shifted
    precision to 0.64 because no training scene contained such decoys);
    'shifted' remains out-of-family through its periodic textures,
    triangle/ring species, and sensor noise.
    """
    base = rng.uniform(20, 160, 3)
    gx = np.linspace(0, 1, w, dtype=np.float32)[None, :, None]
    gy = np.linspace(0, 1, h, dtype=np.float32)[:, None, None]
    img = (base[None, None, :] * (0.6 + 0.4 * gx) * (0.6 + 0.4 * gy))
    img = img + rng.normal(0, 12, (h, w, 3))

    if clutter:
        skin_base = np.array([225, 185, 150], np.float32)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        for _ in range(rng.randint(2, 6)):
            col = rng.uniform(0, 255, 3).astype(np.float32)
            kind = rng.rand()
            if kind < 0.4:         # featureless ellipse (face-sized decoy)
                cx, cy = rng.uniform(0, w), rng.uniform(0, h)
                rx = rng.uniform(0.05, 0.25) * w
                ry = rng.uniform(0.05, 0.25) * h
                m = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1
                img[m] = col
            elif kind < 0.75:      # rectangle
                x1 = rng.randint(0, w)
                y1 = rng.randint(0, h)
                m = (xx >= x1) & (xx < x1 + rng.randint(8, w // 2)) & \
                    (yy >= y1) & (yy < y1 + rng.randint(8, h // 2))
                img[m] = col
            else:                  # skin-toned blob with dark speckles
                col = skin_base * rng.uniform(0.55, 1.05)
                cx, cy = rng.uniform(0, w), rng.uniform(0, h)
                rx = rng.uniform(0.05, 0.18) * w
                ry = rng.uniform(0.05, 0.18) * h
                m = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1
                img[m] = col
                for _dot in range(rng.randint(2, 5)):
                    du = rng.uniform(-0.6, 0.6)
                    dv = rng.uniform(-0.6, 0.6)
                    dr = rng.uniform(0.04, 0.12)
                    dm = (((xx - cx - du * rx) / (dr * rx)) ** 2 +
                          ((yy - cy - dv * ry) / (dr * ry)) ** 2) <= 1
                    img[dm & m] = rng.uniform(10, 70)
    return np.clip(img, 0, 255).astype(np.uint8)


def render_face_patch(size, identity, rng, jitter=True, hard=False):
    """One aligned face crop for identity training ([size, size, 3] uint8).

    The face fills most of the crop (like the 160x160 thumbnails
    `extract_faces` produces); jitter adds pose/scale/lighting variation.

    hard=True is the de-saturated benchmark mode (VERDICT r2 next #2):
    scalar-identity draws become family archetypes + deltas, and per-image
    nuisance goes up — yaw squash, wider rotation/scale/lighting, partial
    occlusion, blur, and sensor noise — so within-class spread overlaps
    between-class distances and pair accuracy leaves the 1.0 ceiling.
    """
    size = int(size)
    p = (identity_params(identity, hard=hard) if np.isscalar(identity)
         else identity)
    img = _background(rng, size, size, clutter=False)

    aspect = 1.0
    if hard:
        half = size * 0.5 * rng.uniform(0.62, 0.95)
        cx = size / 2 + rng.uniform(-0.09, 0.09) * size
        cy = size / 2 + rng.uniform(-0.09, 0.09) * size
        rot = rng.uniform(-0.30, 0.30)
        light = rng.uniform(0.55, 1.45)
        aspect = rng.uniform(0.70, 1.0)      # yaw proxy
    elif jitter:
        half = size * 0.5 * rng.uniform(0.78, 0.95)
        cx = size / 2 + rng.uniform(-0.05, 0.05) * size
        cy = size / 2 + rng.uniform(-0.05, 0.05) * size
        rot = rng.uniform(-0.17, 0.17)
        light = rng.uniform(0.75, 1.25)
    else:
        half, cx, cy, rot, light = size * 0.45, size / 2, size / 2, 0.0, 1.0

    out = _paint_face(img, cx, cy, half, rot, p, light, aspect=aspect)

    if hard:
        # partial occlusion over the face box
        if out is not None and rng.rand() < 0.30:
            b = out[0]
            bw, bh = b[2] - b[0], b[3] - b[1]
            ox = int(b[0] + rng.uniform(0.0, 0.7) * bw)
            oy = int(b[1] + rng.uniform(0.0, 0.7) * bh)
            ow = max(2, int(rng.uniform(0.15, 0.45) * bw))
            oh = max(2, int(rng.uniform(0.10, 0.30) * bh))
            img[max(oy, 0):oy + oh, max(ox, 0):ox + ow] = \
                rng.uniform(0, 255, 3).astype(np.uint8)
        f = img.astype(np.float32)
        if rng.rand() < 0.5:                 # 3x3 box blur
            k = np.ones((3, 3), np.float32) / 9.0
            pad = np.pad(f, ((1, 1), (1, 1), (0, 0)), mode='edge')
            f = sum(pad[dy:dy + size, dx:dx + size] * k[dy, dx]
                    for dy in range(3) for dx in range(3))
        f = f * rng.uniform(0.85, 1.15) + rng.normal(
            0, rng.uniform(3, 9), f.shape)
        img = np.clip(f, 0, 255).astype(np.uint8)

    return img


def render_scene(rng, shape=(256, 256), n_faces=None, identities=None,
                 min_face=24, max_face=None, clutter=True, hard=False):
    """A cluttered scene with 0..N faces and ground truth.

    :param hard: de-saturated identity mode for the detect-chain evidence
        run — archetype+delta identities plus wider rotation/lighting, a
        yaw-squash aspect, and sensor noise (the occlusion/blur nuisance
        of `render_face_patch(hard=True)` is deliberately omitted so the
        bundled detector, trained on clean scenes, still finds faces)
    :returns: (image [H, W, 3] uint8, boxes [G, 4] float32 x1y1x2y2,
        landmarks [G, 5, 2] float32)
    """
    h, w = int(shape[0]), int(shape[1])
    if max_face is None:
        max_face = int(min(h, w) * 0.75)
    if n_faces is None:
        n_faces = rng.randint(1, 4)

    img = _background(rng, h, w, clutter=clutter)
    crowd = 1.0
    boxes, lmks = [], []
    for k in range(n_faces):
        for _attempt in range(12):
            side = rng.uniform(min_face, max_face)
            half = side / 2
            cx = rng.uniform(half * 0.8, w - half * 0.8)
            cy = rng.uniform(half * 0.8, h - half * 0.8)
            # keep faces mostly non-overlapping so boxes are unambiguous
            ok = True
            for b in boxes:
                bx = (b[0] + b[2]) / 2, (b[1] + b[3]) / 2
                min_d = ((b[2] - b[0]) / 2 + half) * crowd
                if abs(cx - bx[0]) < min_d and abs(cy - bx[1]) < min_d:
                    ok = False
                    break
            if not ok:
                continue
            if hard:
                ident = (identity_params(identities[k], hard=True)
                         if identities is not None
                         else identity_params(rng.randint(10 ** 6), salt=7,
                                              hard=True))
                # milder nuisance than render_face_patch(hard=True): the
                # de-saturation comes from the archetype+delta identities;
                # the scenes must stay detectable by the bundled detector
                # (aspect 0.70 / light 0.55-1.45 measured 77% extraction,
                # below the tool's 80% regression gate)
                out = _paint_face(img, cx, cy, half,
                                  rng.uniform(-0.25, 0.25), ident,
                                  rng.uniform(0.65, 1.35),
                                  aspect=rng.uniform(0.80, 1.0))
            else:
                ident = (identity_params(identities[k])
                         if identities is not None
                         else identity_params(rng.randint(10 ** 6), salt=7))
                light = rng.uniform(0.75, 1.25)
                out = _paint_face(img, cx, cy, half, rng.uniform(-0.2, 0.2),
                                  ident, light)
            if out is not None:
                boxes.append(out[0])
                lmks.append(out[1])
            break

    boxes = (np.stack(boxes) if boxes else np.zeros((0, 4), np.float32))
    lmks = (np.stack(lmks) if len(lmks) else np.zeros((0, 5, 2), np.float32))
    if hard:
        f = (img.astype(np.float32) * rng.uniform(0.90, 1.10)
             + rng.normal(0, rng.uniform(2, 6), img.shape))
        img = np.clip(f, 0, 255).astype(np.uint8)
    return img, boxes, lmks
