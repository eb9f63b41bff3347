"""Structure-of-arrays scene representation + host-side builder.

Flat-table re-design of the reference's pointer-graph scene (shared_ptr<hittable>
trees, src/hittable_list.h, src/hittable.h instancing wrappers): every
primitive/material/texture lives in a flat, padded table addressed by integer
id, so the whole scene is one JAX pytree that can be jitted over, replicated
across a device mesh, and differentiated (albedo/emission live in
``Textures.color0``; geometry in the primitive tables).

Design decisions vs the reference:
 - translate/rotate_{x,y,z} wrappers (src/hittable.h:67-293) are *folded into
   primitive parameters at build time* — a rotated/translated quad is still a
   quad; a rotated box boundary becomes an oriented-box volume.
 - materials are referenced by integer id (breaking the L3->L2 dependency
   cycle noted in SURVEY.md §1).
 - ``box()`` (src/quad.h:91-112) becomes six table rows.
 - constant-density volumes (src/volumne.h) store their convex boundary
   analytically (oriented box or sphere) instead of wrapping another hittable.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import jax.numpy as jnp

from cpu_ray_tracing_implementation_tpu.ops import bvh as bvh_mod
from cpu_ray_tracing_implementation_tpu.ops import chunked as chunked_mod
from cpu_ray_tracing_implementation_tpu.ops import noise as noise_ops
from cpu_ray_tracing_implementation_tpu.utils import accel
from cpu_ray_tracing_implementation_tpu.utils import pytree

# material type codes (src/material.h concrete classes)
MAT_LAMBERTIAN = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2
MAT_GLOSS = 3
MAT_ISOTROPIC = 4
MAT_DIFFUSE_LIGHT = 5

# texture type codes (src/texture.h concrete classes)
TEX_SOLID = 0
TEX_CHECKER = 1
TEX_PICTURE = 2
TEX_PERLIN = 3
TEX_VALUE = 4
TEX_WORLEY = 5
TEX_VORONOI = 6

# volume boundary kinds
VOL_BOX = 0
VOL_SPHERE = 1
VOL_MESH = 2


@pytree.dataclass
class Spheres:
    c0: jnp.ndarray      # [S,3] center at time 0
    c1: jnp.ndarray      # [S,3] center at time 1 (== c0 for static; motion blur src/sphere.h:25)
    rad: jnp.ndarray     # [S]
    mat: jnp.ndarray     # [S] int32
    active: jnp.ndarray  # [S] bool (False on padding rows)


@pytree.dataclass
class Quads:
    corner: jnp.ndarray  # [Q,3]
    eu: jnp.ndarray      # [Q,3] edge u
    ev: jnp.ndarray      # [Q,3] edge v
    mat: jnp.ndarray     # [Q] int32
    active: jnp.ndarray  # [Q] bool


@pytree.dataclass
class Triangles:
    v0: jnp.ndarray      # [T,3]
    v1: jnp.ndarray      # [T,3]
    v2: jnp.ndarray      # [T,3]
    mat: jnp.ndarray     # [T] int32
    active: jnp.ndarray  # [T] bool


@pytree.dataclass
class TriAttrs:
    """Per-vertex triangle attributes for smooth shading / texturing —
    beyond reference parity (it loads glTF NORMAL/TEXCOORD_0 then discards
    them, src/main.cc:353-393; SURVEY.md appendix item 8). Rows are in the
    SAME index space as the triangle intersector's winning-primitive id:
    chunk order (utils/accel BVH order, padded) when the scene is chunked,
    raw table order otherwise."""
    n0: jnp.ndarray      # [T,3] unit vertex normals
    n1: jnp.ndarray      # [T,3]
    n2: jnp.ndarray      # [T,3]
    uv0: jnp.ndarray     # [T,2]
    uv1: jnp.ndarray     # [T,2]
    uv2: jnp.ndarray     # [T,2]
    smooth: jnp.ndarray  # [T] bool: interpolate normals (else flat)


@pytree.dataclass
class Volumes:
    kind: jnp.ndarray    # [V] int32: VOL_BOX | VOL_SPHERE | VOL_MESH
    center: jnp.ndarray  # [V,3]
    half: jnp.ndarray    # [V,3] half extents (sphere: radius in [:,0])
    rot: jnp.ndarray     # [V,3,3] object->world rotation
    neg_inv_density: jnp.ndarray  # [V]  -1/density (src/volumne.h:36)
    mat: jnp.ndarray     # [V] int32 (an isotropic material)
    active: jnp.ndarray  # [V] bool
    # triangle-mesh boundaries (VOL_MESH rows): all mesh-volume boundary
    # triangles concatenated. The reference's volumne wraps ANY hittable as
    # the medium boundary (src/volumne.h:9-21); its first-hit / next-hit
    # probe is exact only for convex boundaries, and this table matches that
    # contract with a batched line sweep: entry/exit = min/max t over the
    # volume's triangles along the full line (interval::universe probe,
    # src/volumne.h:21-22). None when the scene has no mesh volumes — the
    # branch then never enters the XLA graph.
    mesh_v0: jnp.ndarray | None = None   # [MT,3]
    mesh_e1: jnp.ndarray | None = None   # [MT,3] v1 - v0
    mesh_e2: jnp.ndarray | None = None   # [MT,3] v2 - v0
    mesh_vid: jnp.ndarray | None = None  # [MT] int32 owning volume row
    mesh_active: jnp.ndarray | None = None  # [MT] bool


@pytree.dataclass
class Materials:
    mtype: jnp.ndarray      # [M] int32
    tex: jnp.ndarray        # [M] int32 texture id (albedo or emission)
    fuzz: jnp.ndarray       # [M] metal fuzz
    ior: jnp.ndarray        # [M] dielectric refraction index at 589 nm
    smoothness: jnp.ndarray # [M] gloss smoothness
    spec_prob: jnp.ndarray  # [M] gloss specular probability
    # Cauchy dispersion coefficient B in um^2: n(lambda) = ior +
    # B*(1/lambda_um^2 - 1/0.589^2). 0 = non-dispersive. Drives the
    # hero-wavelength spectral render mode (ops/spectrum.py) — a LIVE use
    # of the spectral layer the reference only scaffolds (src/spectrum.h).
    dispersion: jnp.ndarray = None  # [M]


@pytree.dataclass
class Textures:
    ttype: jnp.ndarray     # [X] int32
    color0: jnp.ndarray    # [X,3] solid color / checker even
    color1: jnp.ndarray    # [X,3] checker odd
    scale: jnp.ndarray     # [X] checker cell width / perlin scale
    image_id: jnp.ndarray  # [X] int32 index into Scene.images
    # [X] int32 image filter: 0 = nearest (reference parity,
    # src/texture.h:68-74), 1 = bilinear (opt-in, picture(filter=))
    tfilter: jnp.ndarray = None


@pytree.dataclass
class NoiseTables:
    perlin_grad: jnp.ndarray  # [256,3]
    perlin_perm: jnp.ndarray  # [256] int32
    value_grid: jnp.ndarray   # [res,res,res]


@pytree.dataclass
class Scene:
    spheres: Spheres
    quads: Quads
    tris: Triangles
    volumes: Volumes
    materials: Materials
    textures: Textures
    noise: NoiseTables
    images: tuple          # tuple of [h,w,3] float arrays (static length)
    lights: jnp.ndarray    # [L] int32 quad indices used for MIS light sampling
    # [Ls] int32 sphere indices sampled as lights via solid-angle cone
    # sampling (the capability the reference stubs with broken math,
    # src/sphere.h:76-81); None = no sphere lights
    sphere_lights: jnp.ndarray | None = None
    background: int = pytree.static_field(default=-1)  # texture id or -1
    # environment-light importance tables (ops/envlight.py; built when
    # set_background(..., importance_sample=True)): [H,W] per-texel
    # probability + row/col CDFs. None = background found by BSDF sampling
    # only (the reference behavior, src/camera.h:205-210).
    env_texel_p: jnp.ndarray | None = None
    env_row_cdf: jnp.ndarray | None = None
    env_col_cdf: jnp.ndarray | None = None
    # static feature flags: lets the integrator skip texture/volume branches
    # the scene never uses (shapes are static, so this is trace-time constant)
    tex_types_used: tuple = pytree.static_field(default=())
    # real (unpadded) row counts per primitive table: (spheres, quads, tris,
    # volumes). Tables pad to >=1 row; a zero count lets the integrator drop
    # that primitive type from the XLA graph entirely.
    counts: tuple = pytree.static_field(default=(-1, -1, -1, -1))
    # static set of material type codes present (like tex_types_used):
    # unused material families never enter the scatter XLA graph
    mat_types_used: tuple = pytree.static_field(default=())
    # static: any material has a nonzero Cauchy dispersion coefficient —
    # turns on the hero-wavelength spectral path (integrator draws one
    # wavelength per (pixel, sample) path and weights its radiance by the
    # normalized wavelength->RGB response). Off = bitwise the RGB render.
    has_dispersion: bool = pytree.static_field(default=False)
    # static: any picture texture uses bilinear filtering (keeps the
    # 4-tap gather out of nearest-only scenes' graphs)
    has_bilinear: bool = pytree.static_field(default=False)
    # chunk-scan acceleration for large tables (ops/chunked.py): primitives
    # in BVH depth-first order, cut into fixed chunks with AABBs. None for
    # small tables (dense single-pass path).
    sphere_chunks: chunked_mod.SphereChunks | None = None
    quad_chunks: chunked_mod.PlanarChunks | None = None
    tri_chunks: chunked_mod.PlanarChunks | None = None
    # threaded-BVH traversal trees (ops/bvh.py) for the same tables; None
    # when the native builder is unavailable (traversal then falls back to
    # the chunk scan)
    sphere_tree: bvh_mod.BVHTree | None = None
    quad_tree: bvh_mod.BVHTree | None = None
    tri_tree: bvh_mod.BVHTree | None = None
    # build-time BVH permutation (dense row -> chunk-major position) per
    # chunked family: lets diff.apply_scene_params re-derive the chunk
    # tables from updated dense geometry IN-GRAPH (ops/chunked.rechunk_*),
    # which is what makes geometry differentiable on chunked scenes
    sphere_chunk_order: jnp.ndarray | None = None  # [S] int32
    quad_chunk_order: jnp.ndarray | None = None    # [Q] int32
    tri_chunk_order: jnp.ndarray | None = None     # [T] int32
    # per-vertex triangle attributes (smooth normals + UVs); None when no
    # mesh supplied them
    tri_attrs: TriAttrs | None = None
    # static scene AABB (in the traced, recentered frame) — quantization
    # range for the secondary-ray coherence sort keys (ops/raysort.py).
    # Tuples of 3 floats so they are trace-time constants, not device data.
    world_lo: tuple | None = pytree.static_field(default=None)
    world_hi: tuple | None = pytree.static_field(default=None)
    # world-space offset folded out of the geometry at build time when the
    # scene centroid is far from the origin: the matmul-expanded quadratics
    # (|o|^2 - 2 o.c + |c|^2) cancel catastrophically in f32 beyond ~1e3
    # (ops/intersect.py sphere_ts NOTE). Ray origins are shifted by -offset
    # at render entry; position-based textures add it back. None = identity.
    world_offset: jnp.ndarray | None = None

    @property
    def n_volumes(self) -> int:
        return int(self.volumes.kind.shape[0])

    @property
    def n_sphere_lights(self) -> int:
        return 0 if self.sphere_lights is None else int(self.sphere_lights.shape[0])

    @property
    def has_env_light(self) -> bool:
        return self.env_texel_p is not None

    @property
    def has_lights(self) -> bool:
        return (int(self.lights.shape[0]) > 0 or self.n_sphere_lights > 0
                or self.has_env_light)


def _rot_matrix(axis: str, degrees: float) -> np.ndarray:
    """Object->world rotation matching reference rotate_{x,y,z}
    (src/hittable.h:93-293): [c, s; -s, c] on the two non-axis coordinates."""
    th = math.radians(degrees)
    c, s = math.cos(th), math.sin(th)
    m = np.eye(3)
    ij = {"x": (1, 2), "y": (0, 2), "z": (0, 1)}[axis]
    i, j = ij
    m[i, i] = c
    m[i, j] = s
    m[j, i] = -s
    m[j, j] = c
    return m


def _apply_instance(points: np.ndarray, rotate, translate, is_vector: bool = False) -> np.ndarray:
    """Fold a rotate-then-translate instance transform into point/vector data.

    ``rotate``: None or (axis, degrees) or list of them, applied innermost
    first (matching translate(rotate_y(obj)) nesting in the reference scenes).
    """
    out = np.asarray(points, np.float64)
    if rotate is not None:
        rots = [rotate] if isinstance(rotate, tuple) else list(rotate)
        for axis, deg in rots:
            out = out @ _rot_matrix(axis, deg).T
    if translate is not None and not is_vector:
        out = out + np.asarray(translate, np.float64)
    return out


class SceneBuilder:
    """Accumulates python-side lists; ``build()`` emits padded device tables."""

    def __init__(self, seed: int = 0, value_noise_resolution: int = 10):
        self._sph = []   # (c0, c1, rad, mat)
        self._quads = []  # (corner, eu, ev, mat)
        self._tris = []   # (v0, v1, v2, mat)
        self._tri_attrs = []  # None or (normals [3,3], uvs [3,2]) per tri
        self._vols = []   # (kind, center, half, rot, density, mat)
        self._vol_mesh = []  # (vol_row_index, verts [T,3,3]) mesh boundaries
        self._mats = []   # dict rows
        self._texs = []   # dict rows
        self._imgs = []   # np arrays
        self._lights = []
        self._sphere_lights = []
        self._background = -1
        self._env_importance = False
        self._env_res = (64, 128)
        self._seed = seed
        self._value_res = value_noise_resolution

    # ---------------- textures ----------------
    def _tex_row(self, **kw) -> int:
        row = dict(ttype=TEX_SOLID, color0=(0, 0, 0), color1=(0, 0, 0), scale=1.0, image_id=0, tfilter=0)
        row.update(kw)
        self._texs.append(row)
        return len(self._texs) - 1

    def solid(self, color) -> int:
        return self._tex_row(ttype=TEX_SOLID, color0=tuple(color))

    def checker(self, odd, even, scale: float) -> int:
        """3-D position-based checker (src/texture.h:39-63)."""
        return self._tex_row(ttype=TEX_CHECKER, color0=tuple(even), color1=tuple(odd), scale=scale)

    def picture(self, image: np.ndarray, filter: str = "nearest") -> int:
        """Image texture, v flipped, /256 scale (src/texture.h:65-78).
        ``image``: [h,w,3] float in [0,255]-byte scale. ``filter``:
        "nearest" (reference parity) or "bilinear" (opt-in smoothing)."""
        img = np.ascontiguousarray(np.asarray(image, np.float32))
        assert img.ndim == 3 and img.shape[-1] == 3, img.shape
        self._imgs.append(img)
        tf = {"nearest": 0, "bilinear": 1}[filter]
        return self._tex_row(ttype=TEX_PICTURE, image_id=len(self._imgs) - 1,
                             tfilter=tf)

    def perlin(self, scale: float) -> int:
        return self._tex_row(ttype=TEX_PERLIN, scale=scale)

    def value(self, resolution: int) -> int:
        self._value_res = max(self._value_res, int(resolution))
        return self._tex_row(ttype=TEX_VALUE)

    def worley(self) -> int:
        return self._tex_row(ttype=TEX_WORLEY)

    def voronoi(self) -> int:
        return self._tex_row(ttype=TEX_VORONOI)

    def _as_tex(self, tex_or_color) -> int:
        if isinstance(tex_or_color, (int, np.integer)):
            return int(tex_or_color)
        return self.solid(tex_or_color)

    # ---------------- materials ----------------
    def _mat_row(self, **kw) -> int:
        row = dict(mtype=MAT_LAMBERTIAN, tex=0, fuzz=0.0, ior=1.0, smoothness=0.0, spec_prob=0.0, dispersion=0.0)
        row.update(kw)
        self._mats.append(row)
        return len(self._mats) - 1

    def lambertian(self, tex_or_color) -> int:
        return self._mat_row(mtype=MAT_LAMBERTIAN, tex=self._as_tex(tex_or_color))

    def metal(self, tex_or_color, fuzz: float = 0.0) -> int:
        return self._mat_row(mtype=MAT_METAL, tex=self._as_tex(tex_or_color),
                             fuzz=float(np.clip(fuzz, 0.0, 1.0)))

    def dielectric(self, ior: float, tex_or_color=(1.0, 1.0, 1.0),
                   dispersion: float = 0.0) -> int:
        """``dispersion``: Cauchy B in um^2 (BK7 glass ~0.0042; dense flint
        ~0.013). Nonzero turns on the hero-wavelength spectral render mode
        for the whole scene (Scene.has_dispersion)."""
        return self._mat_row(mtype=MAT_DIELECTRIC, tex=self._as_tex(tex_or_color), ior=float(ior),
                             dispersion=float(dispersion))

    def gloss(self, tex_or_color, smoothness: float, spec_prob: float) -> int:
        return self._mat_row(mtype=MAT_GLOSS, tex=self._as_tex(tex_or_color),
                             smoothness=float(np.clip(smoothness, 0.0, 1.0)),
                             spec_prob=float(spec_prob))

    def isotropic(self, tex_or_color) -> int:
        return self._mat_row(mtype=MAT_ISOTROPIC, tex=self._as_tex(tex_or_color))

    def diffuse_light(self, tex_or_color) -> int:
        return self._mat_row(mtype=MAT_DIFFUSE_LIGHT, tex=self._as_tex(tex_or_color))

    # ---------------- primitives ----------------
    def sphere(self, center, radius: float, mat: int) -> int:
        c = np.asarray(center, np.float64)
        self._sph.append((c, c, max(0.0, float(radius)), int(mat)))
        return len(self._sph) - 1

    def moving_sphere(self, center0, center1, radius: float, mat: int) -> int:
        self._sph.append((np.asarray(center0, np.float64), np.asarray(center1, np.float64),
                          max(0.0, float(radius)), int(mat)))
        return len(self._sph) - 1

    def quad(self, corner, u, v, mat: int, rotate=None, translate=None) -> int:
        c = _apply_instance(np.asarray(corner, np.float64), rotate, translate)
        eu = _apply_instance(np.asarray(u, np.float64), rotate, None, is_vector=True)
        ev = _apply_instance(np.asarray(v, np.float64), rotate, None, is_vector=True)
        self._quads.append((c, eu, ev, int(mat)))
        return len(self._quads) - 1

    def box(self, a, b, mat: int, rotate=None, translate=None) -> list:
        """Axis-aligned box as six quads (src/quad.h:91-112), with optional
        folded rotate/translate instance transform."""
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        mn, mx = np.minimum(a, b), np.maximum(a, b)
        dx = np.array([mx[0] - mn[0], 0, 0])
        dy = np.array([0, mx[1] - mn[1], 0])
        dz = np.array([0, 0, mx[2] - mn[2]])
        faces = [
            ((mn[0], mn[1], mx[2]), dy, dx),    # front
            ((mx[0], mn[1], mx[2]), dy, -dz),   # right
            ((mx[0], mn[1], mn[2]), dy, -dx),   # back
            ((mn[0], mn[1], mn[2]), dy, dz),    # left
            ((mn[0], mx[1], mx[2]), -dz, dx),   # top
            ((mn[0], mn[1], mn[2]), dz, dx),    # bottom
        ]
        return [self.quad(c, u, v, mat, rotate=rotate, translate=translate) for c, u, v in faces]

    def triangle(self, p0, p1, p2, mat: int, rotate=None, translate=None) -> int:
        pts = _apply_instance(np.stack([np.asarray(p, np.float64) for p in (p0, p1, p2)]),
                              rotate, translate)
        self._tris.append((pts[0], pts[1], pts[2], int(mat)))
        self._tri_attrs.append(None)
        return len(self._tris) - 1

    def triangles(self, verts: np.ndarray, mat: int, rotate=None, translate=None,
                  normals: np.ndarray | None = None,
                  uvs: np.ndarray | None = None):
        """Bulk add [T,3,3] triangle vertices (glTF meshes, main.cc:345-498).

        ``normals`` [T,3,3] / ``uvs`` [T,3,2]: optional per-vertex
        attributes (glTF NORMAL/TEXCOORD_0) — interpolated at shading time
        (barycentric), which the reference parses but never uses
        (SURVEY.md appendix item 8)."""
        verts = _apply_instance(np.asarray(verts, np.float64).reshape(-1, 3),
                                rotate, translate).reshape(-1, 3, 3)
        if normals is not None:
            normals = _apply_instance(
                np.asarray(normals, np.float64).reshape(-1, 3), rotate, None,
                is_vector=True).reshape(-1, 3, 3)
        if uvs is not None:
            uvs = np.asarray(uvs, np.float64).reshape(-1, 3, 2)
        for i, t in enumerate(verts):
            self._tris.append((t[0], t[1], t[2], int(mat)))
            n_i = normals[i] if normals is not None else None
            uv_i = uvs[i] if uvs is not None else None
            self._tri_attrs.append(None if n_i is None and uv_i is None
                                   else (n_i, uv_i))

    def gltf_asset(self, asset, default_mat: int | None = None,
                   filter: str = "nearest") -> int:
        """Add every primitive of a ``utils.gltf.GltfAsset`` bound to its
        OWN glTF material: baseColorTexture (sampled via the primitive's
        UVs) or solid baseColorFactor, as a lambertian surface. This is the
        binding the reference parses and then drops — no main.cc scene ever
        reads the loader's materials (src/gltf_loader.h:706-758).

        A non-unit factor premultiplies the texture host-side (glTF's
        baseColor = factor * texture). ``default_mat``: material for
        primitives without one (default: white lambertian). Returns the
        number of triangles added."""
        import numpy as _np

        mat_cache: dict = {}

        def mat_for(mi: int) -> int:
            if mi in mat_cache:
                return mat_cache[mi]
            if mi < 0 or mi >= len(asset.materials):
                mid = (default_mat if default_mat is not None
                       else self.lambertian((1.0, 1.0, 1.0)))
            else:
                m = asset.materials[mi]
                f = _np.asarray(m.base_color_factor[:3], _np.float32)
                if m.base_color_image is not None:
                    img = m.base_color_image
                    if not _np.allclose(f, 1.0):
                        img = img * f[None, None, :]
                    mid = self.lambertian(self.picture(img, filter=filter))
                else:
                    mid = self.lambertian(tuple(f))
            mat_cache[mi] = mid
            return mid

        n = 0
        for p in asset.primitives:
            if not len(p.indices):
                continue
            corners = p.indices.reshape(-1, 3)
            normals = p.normals[corners] if p.normals is not None else None
            uvs = None
            if p.uvs is not None:
                uvs = p.uvs[corners].copy()
                # glTF UV origin is top-left; picture textures sample with
                # the reference's bottom-left v-flip (src/texture.h:68-74)
                uvs[..., 1] = 1.0 - uvs[..., 1]
            self.triangles(p.triangles, mat_for(p.material),
                           normals=normals, uvs=uvs)
            n += len(corners)
        return n

    def volume_box(self, a, b, density: float, tex_or_color, rotate=None, translate=None):
        """Constant-density medium in a (possibly rotated) box boundary
        (src/volumne.h + the smoke boxes in main.cc:227-283)."""
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        center = (a + b) / 2.0
        half = np.abs(b - a) / 2.0
        rot = np.eye(3)
        if rotate is not None:
            rots = [rotate] if isinstance(rotate, tuple) else list(rotate)
            for axis, deg in rots:
                rot = _rot_matrix(axis, deg) @ rot
        center = rot @ center
        if translate is not None:
            center = center + np.asarray(translate, np.float64)
        mat = self.isotropic(tex_or_color)
        self._vols.append((VOL_BOX, center, half, rot, float(density), mat))
        return len(self._vols) - 1

    def volume_sphere(self, center, radius: float, density: float, tex_or_color):
        mat = self.isotropic(tex_or_color)
        self._vols.append((VOL_SPHERE, np.asarray(center, np.float64),
                           np.array([radius, radius, radius]), np.eye(3), float(density), mat))
        return len(self._vols) - 1

    def volume_mesh(self, verts: np.ndarray, density: float, tex_or_color,
                    rotate=None, translate=None):
        """Constant-density medium bounded by a closed triangle mesh
        ([T,3,3] vertices). Closes the reference's wrap-any-hittable volume
        generality (src/volumne.h:9-21): the boundary is probed along the
        whole line (interval::universe, src/volumne.h:21-22) and the medium
        span is [first hit, last hit] — exact for convex closed meshes, the
        same convexity assumption the reference's first-hit/next-hit probe
        makes. Non-convex meshes are filled between their per-ray entry and
        final exit (cavities along the ray are treated as medium)."""
        verts = _apply_instance(np.asarray(verts, np.float64).reshape(-1, 3),
                                rotate, translate).reshape(-1, 3, 3)
        mat = self.isotropic(tex_or_color)
        centroid = verts.reshape(-1, 3).mean(axis=0)
        self._vols.append((VOL_MESH, centroid, np.ones(3), np.eye(3),
                           float(density), mat))
        vid = len(self._vols) - 1
        self._vol_mesh.append((vid, verts))
        return vid

    def light(self, quad_id: int):
        """Register a quad as an MIS-sampled light (the ``light`` argument to
        camera::render, src/camera.h:135, src/main.cc:224)."""
        self._lights.append(int(quad_id))

    def sphere_light(self, sphere_id: int):
        """Register a sphere as an MIS-sampled light (solid-angle cone
        sampling, ops/sampling.cone_dir). The reference declares this hook
        but its pdf/random are dimensionally wrong placeholders
        (src/sphere.h:76-81); no reference scene uses them."""
        self._sphere_lights.append(int(sphere_id))

    def set_background(self, tex_id: int, importance_sample: bool = False,
                       env_res: tuple = (64, 128)):
        """``importance_sample=True`` registers the background as an MIS
        light: its luminance is tabulated on an (H, W) equirect grid at
        build time and directions are drawn proportional to it
        (ops/envlight.py). Default off = reference-parity BSDF-only."""
        self._background = int(tex_id)
        self._env_importance = bool(importance_sample)
        self._env_res = tuple(env_res)

    # beyond this centroid distance from the origin, geometry is recentered
    # at build time (f32 catastrophic-cancellation guard; see Scene.world_offset)
    RECENTER_THRESHOLD = 2000.0

    def _maybe_recenter(self) -> np.ndarray | None:
        """Fold a size-weighted scene centroid out of all geometry when it
        is far from the origin. Returns the offset (world = stored +
        offset) or None.

        Weights are 1/feature-size: f32 cancellation in the expanded
        quadratics scales with |center|^2 / size^2, so SMALL primitives are
        the precision-critical ones — a huge ground sphere must not drag
        the new origin away from the unit-scale features sitting on it.
        """
        pts, wts = [], []

        def add(center, size):
            pts.append(np.asarray(center, np.float64))
            wts.append(1.0 / max(float(size), 1e-6))

        for r in self._sph:
            add(r[0], r[2])
        for r in self._quads:
            add(np.asarray(r[0], np.float64)
                + 0.5 * (np.asarray(r[1], np.float64) + np.asarray(r[2], np.float64)),
                max(np.linalg.norm(r[1]), np.linalg.norm(r[2])))
        for r in self._tris:
            v0 = np.asarray(r[0], np.float64)
            add((v0 + np.asarray(r[1], np.float64) + np.asarray(r[2], np.float64)) / 3.0,
                max(np.linalg.norm(np.asarray(r[1], np.float64) - v0),
                    np.linalg.norm(np.asarray(r[2], np.float64) - v0)))
        for r in self._vols:
            add(r[1], np.linalg.norm(r[2]))
        if not pts:
            return None
        w = np.asarray(wts)[:, None]
        centroid = (np.stack(pts) * w).sum(axis=0) / w.sum()
        if np.linalg.norm(centroid) <= self.RECENTER_THRESHOLD:
            return None
        off = centroid.astype(np.float32).astype(np.float64)
        self._sph = [(r[0] - off, r[1] - off, r[2], r[3]) for r in self._sph]
        self._quads = [(r[0] - off, r[1], r[2], r[3]) for r in self._quads]
        self._tris = [(r[0] - off, r[1] - off, r[2] - off, r[3])
                      for r in self._tris]
        self._vols = [(r[0], r[1] - off, r[2], r[3], r[4], r[5])
                      for r in self._vols]
        return off

    # ---------------- build ----------------
    def build(self) -> Scene:
        f32 = np.float32
        world_offset = self._maybe_recenter()

        def stack3(rows, idx):
            if rows:
                return np.stack([np.asarray(r[idx], f32) for r in rows])
            return np.zeros((0, 3), f32)

        def col(rows, idx, dtype=f32):
            return np.array([r[idx] for r in rows], dtype) if rows else np.zeros((0,), dtype)

        def pad(arr, n, fill=0):
            """Pad leading axis to n rows."""
            if arr.shape[0] >= n:
                return arr
            pad_shape = (n - arr.shape[0],) + arr.shape[1:]
            return np.concatenate([arr, np.full(pad_shape, fill, arr.dtype)], axis=0)

        def table(rows, specs, n_min=1):
            n = max(n_min, len(rows))
            out = []
            for idx, dtype, fill in specs:
                if dtype == "vec3":
                    a = pad(stack3(rows, idx), n, fill)
                elif dtype == "mat3":
                    a = (np.stack([np.asarray(r[idx], f32) for r in rows])
                         if rows else np.zeros((0, 3, 3), f32))
                    a = pad(a, n, fill)
                else:
                    a = pad(col(rows, idx, dtype), n, fill)
                out.append(jnp.asarray(a))
            active = np.zeros((n,), bool)
            active[: len(rows)] = True
            out.append(jnp.asarray(active))
            return out

        sph = Spheres(*table(self._sph, [(0, "vec3", 0), (1, "vec3", 0), (2, f32, 0), (3, np.int32, 0)]))
        qds = Quads(*table(self._quads, [(0, "vec3", 0), (1, "vec3", 0), (2, "vec3", 0), (3, np.int32, 0)]))
        # pad edge vectors of inactive quads to unit axes so cross products stay finite
        tri = Triangles(*table(self._tris, [(0, "vec3", 0), (1, "vec3", 0), (2, "vec3", 0), (3, np.int32, 0)]))

        # -------- chunk-scan acceleration for large tables (ops/chunked.py)
        C = chunked_mod.CHUNK

        MAX_LEAF = 8

        def chunkify(cols, lo, hi, mats):
            """BVH-order, pad to a CHUNK multiple, reshape chunk-major.
            Also returns the builder's node array (None under the numpy
            Morton fallback) for the device-side traversal tree."""
            n = len(lo)
            centroid = (lo + hi) / 2.0
            order, nodes = accel.build_bvh(centroid, lo, hi, max_leaf=MAX_LEAF)
            k = (n + C - 1) // C
            pad_n = k * C - n
            out = []
            for col in cols:
                a = np.asarray(col, f32)[order]
                pad_shape = (pad_n,) + a.shape[1:]
                a = np.concatenate([a, np.zeros(pad_shape, a.dtype)], axis=0)
                out.append(jnp.asarray(a.reshape((k, C) + a.shape[1:])))
            m = np.concatenate([np.asarray(mats, np.int32)[order],
                                np.zeros(pad_n, np.int32)])
            act = np.concatenate([np.ones(n, bool), np.zeros(pad_n, bool)])
            clo, chi = accel.chunk_bounds(lo[order], hi[order], C)
            return (out, jnp.asarray(m.reshape(k, C)),
                    jnp.asarray(act.reshape(k, C)),
                    jnp.asarray(clo), jnp.asarray(chi), nodes, order)

        sphere_chunks = sphere_tree = None
        sphere_order = None
        if len(self._sph) > chunked_mod.DENSE_MAX:
            c0 = np.stack([np.asarray(r[0], f32) for r in self._sph])
            c1 = np.stack([np.asarray(r[1], f32) for r in self._sph])
            rad = np.array([r[2] for r in self._sph], f32)
            lo = np.minimum(c0, c1) - rad[:, None]
            hi = np.maximum(c0, c1) + rad[:, None]
            (cols, m, act, clo, chi, nodes, sphere_order) = chunkify(
                [c0, c1, rad], lo, hi, [r[3] for r in self._sph])
            sphere_chunks = chunked_mod.SphereChunks(
                c0=cols[0], c1=cols[1], rad=cols[2], mat=m, active=act,
                lo=clo, hi=chi)
            if nodes is not None:
                sphere_tree = bvh_mod.build_tree(
                    nodes, bvh_mod.flatten_chunk_pack(
                        bvh_mod.pack_sphere_constants(sphere_chunks)), MAX_LEAF)

        def planar_chunks(rows):
            corner = np.stack([np.asarray(r[0], f32) for r in rows])
            eu = np.stack([np.asarray(r[1], f32) for r in rows])
            ev = np.stack([np.asarray(r[2], f32) for r in rows])
            pts = np.stack([corner, corner + eu, corner + ev, corner + eu + ev])
            lo = pts.min(axis=0) - 1e-4   # pad degenerate axes (src/aabb.h:81-86)
            hi = pts.max(axis=0) + 1e-4
            (cols, m, act, clo, chi, nodes, order) = chunkify(
                [corner, eu, ev], lo, hi, [r[3] for r in rows])
            chunks = chunked_mod.PlanarChunks(
                corner=cols[0], eu=cols[1], ev=cols[2], mat=m, active=act,
                lo=clo, hi=chi)
            tree = None
            if nodes is not None:
                tree = bvh_mod.build_tree(
                    nodes, bvh_mod.flatten_chunk_pack(
                        bvh_mod.pack_prim_constants(chunks)), MAX_LEAF)
            return chunks, tree, order

        quad_chunks = quad_tree = None
        quad_order = None
        if len(self._quads) > chunked_mod.DENSE_MAX:
            quad_chunks, quad_tree, quad_order = planar_chunks(self._quads)
        tri_chunks = tri_tree = None
        tri_order = None
        if len(self._tris) > chunked_mod.DENSE_MAX:
            tri_rows = [(r[0], np.asarray(r[1], f32) - np.asarray(r[0], f32),
                         np.asarray(r[2], f32) - np.asarray(r[0], f32), r[3])
                        for r in self._tris]
            tri_chunks, tri_tree, tri_order = planar_chunks(tri_rows)

        # -------- per-vertex triangle attributes (smooth normals / UVs)
        tri_attrs = None
        if any(a is not None for a in self._tri_attrs):
            n_raw = len(self._tris)
            nrm = np.zeros((n_raw, 3, 3), f32)
            uv = np.zeros((n_raw, 3, 2), f32)
            smooth = np.zeros((n_raw,), bool)
            for i, a in enumerate(self._tri_attrs):
                if a is None:
                    continue
                n_i, uv_i = a
                if n_i is not None:
                    nrm[i] = np.asarray(n_i, f32)
                    smooth[i] = True
                if uv_i is not None:
                    uv[i] = np.asarray(uv_i, f32)
            # match the intersector's pid space: chunk order (padded) when
            # chunked, raw table order (padded to the dense table) otherwise
            if tri_order is not None:
                nrm, uv, smooth = nrm[tri_order], uv[tri_order], smooth[tri_order]
                n_rows = int(tri_chunks.mat.shape[0] * tri_chunks.mat.shape[1])
            else:
                n_rows = max(1, n_raw)
            nrm = pad(nrm, n_rows)
            uv = pad(uv, n_rows)
            smooth = pad(smooth, n_rows)
            tri_attrs = TriAttrs(
                n0=jnp.asarray(nrm[:, 0]), n1=jnp.asarray(nrm[:, 1]),
                n2=jnp.asarray(nrm[:, 2]),
                uv0=jnp.asarray(uv[:, 0]), uv1=jnp.asarray(uv[:, 1]),
                uv2=jnp.asarray(uv[:, 2]),
                smooth=jnp.asarray(smooth))

        vol_rows = self._vols
        n_v = max(1, len(vol_rows))
        vols = Volumes(
            kind=jnp.asarray(pad(col(vol_rows, 0, np.int32), n_v)),
            center=jnp.asarray(pad(stack3(vol_rows, 1), n_v)),
            half=jnp.asarray(pad(stack3(vol_rows, 2), n_v, 1)),
            rot=jnp.asarray(pad(np.stack([np.asarray(r[3], f32) for r in vol_rows])
                                if vol_rows else np.zeros((0, 3, 3), f32), n_v)),
            neg_inv_density=jnp.asarray(pad(np.array([-1.0 / r[4] for r in vol_rows], f32), n_v, -1)),
            mat=jnp.asarray(pad(col(vol_rows, 5, np.int32), n_v)),
            active=jnp.asarray(np.arange(n_v) < len(vol_rows)),
        )
        if self._vol_mesh:
            mv = np.concatenate([m[1] for m in self._vol_mesh]).astype(f32)
            mvid = np.concatenate([np.full(len(m[1]), m[0], np.int32)
                                   for m in self._vol_mesh])
            n_mt = len(mv)
            vols = vols.replace(
                mesh_v0=jnp.asarray(mv[:, 0]),
                mesh_e1=jnp.asarray(mv[:, 1] - mv[:, 0]),
                mesh_e2=jnp.asarray(mv[:, 2] - mv[:, 0]),
                mesh_vid=jnp.asarray(mvid),
                mesh_active=jnp.asarray(np.ones(n_mt, bool)),
            )

        if not self._mats:
            self._mat_row()
        mats = Materials(
            mtype=jnp.asarray(np.array([m["mtype"] for m in self._mats], np.int32)),
            tex=jnp.asarray(np.array([m["tex"] for m in self._mats], np.int32)),
            fuzz=jnp.asarray(np.array([m["fuzz"] for m in self._mats], f32)),
            ior=jnp.asarray(np.array([m["ior"] for m in self._mats], f32)),
            smoothness=jnp.asarray(np.array([m["smoothness"] for m in self._mats], f32)),
            spec_prob=jnp.asarray(np.array([m["spec_prob"] for m in self._mats], f32)),
            dispersion=jnp.asarray(np.array([m["dispersion"] for m in self._mats], f32)),
        )

        if not self._texs:
            self._tex_row()
        texs = Textures(
            ttype=jnp.asarray(np.array([t["ttype"] for t in self._texs], np.int32)),
            color0=jnp.asarray(np.array([t["color0"] for t in self._texs], f32)),
            color1=jnp.asarray(np.array([t["color1"] for t in self._texs], f32)),
            scale=jnp.asarray(np.array([t["scale"] for t in self._texs], f32)),
            image_id=jnp.asarray(np.array([t["image_id"] for t in self._texs], np.int32)),
            tfilter=jnp.asarray(np.array([t["tfilter"] for t in self._texs], np.int32)),
        )

        grad, perm = noise_ops.make_perlin_tables(self._seed)
        noise = NoiseTables(
            perlin_grad=jnp.asarray(grad),
            perlin_perm=jnp.asarray(perm),
            value_grid=jnp.asarray(noise_ops.make_value_grid(self._value_res, self._seed + 1)),
        )

        images = tuple(jnp.asarray(im) for im in self._imgs) or (jnp.zeros((1, 1, 3), f32),)

        tex_types_used = tuple(sorted({t["ttype"] for t in self._texs}))

        # static scene AABB (traced frame) for the secondary-ray coherence
        # sort (ops/raysort.py): conservative union over all primitive bounds
        blo = np.full(3, np.inf)
        bhi = np.full(3, -np.inf)

        def acc(lo_pts, hi_pts=None):
            nonlocal blo, bhi
            blo = np.minimum(blo, np.min(lo_pts, axis=0))
            bhi = np.maximum(bhi, np.max(hi_pts if hi_pts is not None
                                         else lo_pts, axis=0))

        if self._sph:
            c0 = np.stack([np.asarray(r[0], np.float64) for r in self._sph])
            c1 = np.stack([np.asarray(r[1], np.float64) for r in self._sph])
            rr = np.array([r[2] for r in self._sph])[:, None]
            acc(np.minimum(c0, c1) - rr, np.maximum(c0, c1) + rr)
        if self._quads:
            qc = np.stack([np.asarray(r[0], np.float64) for r in self._quads])
            qu = np.stack([np.asarray(r[1], np.float64) for r in self._quads])
            qv = np.stack([np.asarray(r[2], np.float64) for r in self._quads])
            pts = np.stack([qc, qc + qu, qc + qv, qc + qu + qv])
            acc(pts.min(axis=0), pts.max(axis=0))
        if self._tris:
            tv = np.stack([[np.asarray(r[i], np.float64) for i in range(3)]
                           for r in self._tris])      # [n,3,3]
            acc(tv.min(axis=1), tv.max(axis=1))
        if self._vols:
            vc = np.stack([np.asarray(r[1], np.float64) for r in self._vols])
            vr = np.array([np.linalg.norm(r[2]) for r in self._vols])[:, None]
            acc(vc - vr, vc + vr)
        have_bounds = bool(np.isfinite(blo).all() and np.isfinite(bhi).all())

        scene = Scene(
            spheres=sph,
            quads=qds,
            tris=tri,
            volumes=vols,
            materials=mats,
            textures=texs,
            noise=noise,
            images=images,
            lights=jnp.asarray(np.array(self._lights, np.int32)),
            sphere_lights=(jnp.asarray(np.array(self._sphere_lights, np.int32))
                           if self._sphere_lights else None),
            background=self._background,
            tex_types_used=tex_types_used,
            mat_types_used=tuple(sorted({m["mtype"] for m in self._mats})),
            has_dispersion=any(m["dispersion"] != 0.0 for m in self._mats),
            has_bilinear=any(t["tfilter"] == 1 for t in self._texs),
            counts=(len(self._sph), len(self._quads), len(self._tris), len(self._vols)),
            sphere_chunks=sphere_chunks,
            quad_chunks=quad_chunks,
            tri_chunks=tri_chunks,
            sphere_tree=sphere_tree,
            quad_tree=quad_tree,
            tri_tree=tri_tree,
            sphere_chunk_order=(jnp.asarray(np.asarray(sphere_order, np.int32))
                                if sphere_order is not None else None),
            quad_chunk_order=(jnp.asarray(np.asarray(quad_order, np.int32))
                              if quad_order is not None else None),
            tri_chunk_order=(jnp.asarray(np.asarray(tri_order, np.int32))
                             if tri_order is not None else None),
            tri_attrs=tri_attrs,
            world_lo=tuple(float(x) for x in blo) if have_bounds else None,
            world_hi=tuple(float(x) for x in bhi) if have_bounds else None,
            world_offset=(jnp.asarray(world_offset, jnp.float32)
                          if world_offset is not None else None),
        )

        if self._env_importance and self._background >= 0:
            # needs the built scene (texture tables) to rasterize the
            # background's luminance grid
            from cpu_ray_tracing_implementation_tpu.ops import envlight

            pdf, row_cdf, col_cdf = envlight.build_tables(
                scene, self._env_res)
            scene = scene.replace(env_texel_p=pdf, env_row_cdf=row_cdf,
                                  env_col_cdf=col_cdf)
        return scene
