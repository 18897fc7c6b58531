"""The modality front ends held against the JAX package's, on the CPU.

M-RoPE angles, sinusoidal positions, MusicGen's codebook embedding and
heads and Qwen2-VL's vision merger, then the two models whole
(musicgen-medium and qwen2-vl-72b smoke): the training forward and loss
(the vision prefix's targets ignored), prefill and decode at scalar and
per-slot positions, decode with per-step ``positions_3d``.  Both packages
get the JAX package's f32 weights (``convert.params_from_numpy``) and its
batches as numpy; values agree within the reference's f32 tolerance (rtol
2e-4 / atol 2e-3).  Also: the synthetic batches' keys, shapes, dtypes and
draw order, the group-wise init of both families, and the schedule sweep
over them.
"""
import contextlib
import dataclasses
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.data.synthetic import SyntheticConfig as JaxSC
from repro.data.synthetic import synthetic_batch as jax_batch
from repro.models import frontends as jax_fe
from repro.models import rope as jax_rope
from repro.models import transformer as jax_tf
from repro.train import steps as jax_steps
from repro_torch.configs import get_smoke_config, vision_prefix_len
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.core import schedcheck as sc
from repro_torch.core import tree as tr
from repro_torch.core.weightstream import WeightStreamPlan
from repro_torch.data.synthetic import SyntheticConfig, batch_generator, synthetic_batch
from repro_torch.device import generator
from repro_torch.models import frontends, rope, transformer
from repro_torch.train import steps as st

TOL = dict(rtol=2e-4, atol=2e-3)
FRONTENDS = ("musicgen-medium", "qwen2-vl-72b")
B, S, STEPS = 2, 11, 3


def _cfgs(arch, **kw):
    """(port config, JAX config): the smoke config in f32."""
    kw = {"dtype": "float32", **kw}
    return (dataclasses.replace(get_smoke_config(arch), **kw),
            dataclasses.replace(jax_smoke(arch), **kw))


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    _, jc = _cfgs(arch)
    return jax.tree.map(np.asarray, jax_steps.init_train_state(jax.random.PRNGKey(0), jc)[0])


def _params(arch, **kw):
    pc, _ = _cfgs(arch, **kw)
    return params_from_numpy(_jax_params(arch), pc, "cpu")


def _batch(arch, step=0, seq=S, batch=B):
    _, jc = _cfgs(arch)
    b = jax_batch(jc, JaxSC(jc.vocab_size, seq, batch, seed=3), step)
    return {k: np.asarray(v) for k, v in b.items()}


def _t(batch):
    return {k: tensor_from_numpy(v) for k, v in batch.items()}


def _close(ours, theirs, tol=TOL):
    np.testing.assert_allclose(ours.detach().float().numpy(), np.asarray(theirs, np.float32), **tol)


# ---------------------------------------------------------------------------
# positions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("head_dim,sections", [(16, (2, 3, 3)), (128, (16, 24, 24))])
def test_mrope_angles_equal_jax(head_dim, sections):
    """Grid-shaped ids (distinct in each plane): the JAX package's angles in
    f32, and bit for bit each band's plane's RoPE angle (the value of its
    one-hot einsum; the inverse frequencies themselves may differ from
    XLA's ``pow`` by an ulp)."""
    rng = np.random.default_rng(0)
    pos = rng.integers(0, 4096, (2, 3, 37)).astype(np.int32)
    theirs = jax_rope.mrope_angles(jnp.asarray(pos), head_dim, 1e6, sections)
    ours = rope.mrope_angles(tensor_from_numpy(pos), head_dim, 1e6, sections)
    assert ours.dtype == torch.float32 and tuple(ours.shape) == (2, 37, head_dim // 2)
    _close(ours, theirs)
    per_plane = rope.rope_angles(tensor_from_numpy(pos), head_dim, 1e6)  # (2, 3, 37, H/2)
    plane = np.repeat(np.arange(3), sections)
    want = torch.stack([per_plane[:, plane[h], :, h] for h in range(head_dim // 2)], dim=-1)
    assert torch.equal(ours, want)
    # text ids (one id in all three planes) give plain RoPE's angles
    text = np.broadcast_to(np.arange(37, dtype=np.int32)[None, None], (2, 3, 37))
    np.testing.assert_array_equal(
        rope.mrope_angles(tensor_from_numpy(text.copy()), head_dim, 1e6, sections).numpy(),
        rope.rope_angles(torch.arange(37)[None].expand(2, 37), head_dim, 1e6).numpy())


def test_mrope_sections_must_cover_half_the_head():
    with pytest.raises(ValueError, match="must sum to head_dim/2=8"):
        rope.mrope_angles(torch.zeros((1, 3, 4), dtype=torch.int32), 16, 1e4, (2, 3, 2))


@pytest.mark.parametrize("shape", [(7,), (3, 5)])
def test_sinusoidal_embedding_matches_jax(shape):
    pos = np.random.default_rng(1).integers(0, 5000, shape).astype(np.int32)
    ours = rope.sinusoidal_embedding(tensor_from_numpy(pos), 64)
    theirs = jax_rope.sinusoidal_embedding(jnp.asarray(pos), 64)
    _close(ours, theirs)


@pytest.mark.parametrize("pos", [None, 9, [9, 4]], ids=["sequence", "scalar", "per-slot"])
def test_embed_positions_match_jax(pos):
    """musicgen's embedding with its sinusoidal positions: a whole sequence
    from 0, one step at a scalar position, one step at per-slot positions."""
    pc, jc = _cfgs("musicgen-medium")
    p = _jax_params("musicgen-medium")
    codes = _batch("musicgen-medium")["codes"]
    if pos is not None:
        codes = codes[..., :1]
    jpos = None if pos is None else jnp.asarray(pos, jnp.int32)
    tpos = None if pos is None else torch.tensor(pos, dtype=torch.int32)
    theirs = jax_tf._embed(jc, p, {"codes": jnp.asarray(codes)}, pos=jpos)
    ours = transformer._embed(pc, _params("musicgen-medium").as_dict(),
                              {"codes": tensor_from_numpy(codes)}, pos=tpos)
    assert ours.shape == theirs.shape
    _close(ours, theirs)


# ---------------------------------------------------------------------------
# the front-end functions
# ---------------------------------------------------------------------------


def test_audio_frontend_matches_jax():
    pc, _ = _cfgs("musicgen-medium")
    emb = _jax_params("musicgen-medium")["embed"]
    ours_p = {k: tensor_from_numpy(v) for k, v in emb.items()}
    codes = _batch("musicgen-medium")["codes"]
    _close(frontends.audio_embed_apply(ours_p, tensor_from_numpy(codes), torch.float32),
           jax_fe.audio_embed_apply(emb, jnp.asarray(codes), jnp.float32))
    x = np.random.default_rng(2).standard_normal((B, S, pc.d_model)).astype(np.float32)
    logits = frontends.audio_heads_apply(ours_p, tensor_from_numpy(x))
    assert tuple(logits.shape) == (B, pc.n_codebooks, S, pc.vocab_size)
    _close(logits, jax_fe.audio_heads_apply(emb, jnp.asarray(x)))


def test_vision_merger_matches_jax():
    pc, _ = _cfgs("qwen2-vl-72b")
    vis = _jax_params("qwen2-vl-72b")["vision"]
    x = np.random.default_rng(3).standard_normal((B, 5, pc.d_model)).astype(np.float32)
    _close(frontends.vision_merge_apply({"proj": tensor_from_numpy(vis["proj"])},
                                        tensor_from_numpy(x)),
           jax_fe.vision_merge_apply(vis, jnp.asarray(x)))


@pytest.mark.parametrize("arch", FRONTENDS)
def test_init_names_shapes_and_scales_match_jax(arch):
    """The front ends' leaves under the JAX package's names and shapes, at
    its init scales: trunc-normal 0.02 codebooks, fan-in heads and merger."""
    pc = get_smoke_config(arch)
    ours = {n: tuple(p.shape) for n, p in
            transformer.init_model(pc, torch.Generator(), "meta").named_parameters()}
    theirs = jax_steps.abstract_params(jax_smoke(arch))
    flat = {".".join(str(k.key) for k in path): tuple(x.shape)
            for path, x in jax.tree_util.tree_flatten_with_path(theirs)[0]}
    assert ours == flat
    # the init scales, at a width whose samples pin the standard deviations
    wide = dataclasses.replace(pc, d_model=256, vocab_size=1024)
    shell = transformer.init_model_shell(wide, generator(0), "cpu")
    trunc = 0.8796  # the standard deviation of a unit normal truncated at +-2
    if pc.n_codebooks:
        assert list(shell) == ["embed", "ln_f"] and list(shell["embed"]) == ["codebooks", "heads"]
        assert abs(float(shell["embed"]["codebooks"].std()) / 0.02 - trunc) < 1e-2
        assert abs(float(shell["embed"]["heads"].std()) * 256 ** 0.5 - trunc) < 1e-2
    else:
        assert list(shell) == ["embed", "head", "vision", "ln_f"]
        assert abs(float(shell["vision"]["proj"].std()) * 256 ** 0.5 - trunc) < 1e-2


@pytest.mark.parametrize("arch", FRONTENDS)
def test_groupwise_init_is_init_model_bitwise(arch):
    """The streamed-weight init draws the shell (codebooks and heads, the
    untied head, the merger) and then each layer group, as init_model draws
    the whole tree."""
    pc = dataclasses.replace(get_smoke_config(arch), n_layers=3)
    plan = WeightStreamPlan(pc, st.abstract_params(pc), layers_per_group=2)
    home = st.init_weight_streamed_params(pc, plan, 5, "cpu")
    whole = plan.init_home(st.init_params(pc, 5, "cpu"))
    assert list(home["groups"]["g000_embed"]) == (["embed"] if pc.n_codebooks
                                                   else ["embed", "vision"])
    for key in whole["groups"]:
        for a, b in zip(tr.leaves(home["groups"][key]), tr.leaves(whole["groups"][key])):
            assert np.array_equal(np.asarray(a).view(np.uint8), np.asarray(b).view(np.uint8))


def test_every_config_is_supported():
    from repro_torch.configs import ARCHS

    for arch in ARCHS:
        transformer.check_supported(get_smoke_config(arch))
    with pytest.raises(NotImplementedError, match="'alibi' positions"):
        transformer.check_supported(dataclasses.replace(get_smoke_config("smollm-360m"),
                                                        pos_type="alibi"))


# ---------------------------------------------------------------------------
# the models whole
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [0, 4], ids=["whole", "chunked"])
@pytest.mark.parametrize("arch", FRONTENDS)
def test_forward_train_and_lm_loss_match_jax(arch, chunk):
    """Logits ((B, K, S, V) with codebooks; S counts the vision prefix) and
    the loss, whole and seq-chunked; the prefix carries no targets."""
    pc, jc = _cfgs(arch, loss_chunk=chunk)
    p = _jax_params(arch)
    b = _batch(arch, 1, seq=16)
    logits, _ = jax_tf.forward_train(jc, p, b)
    loss, aux = jax_tf.lm_loss(jc, p, b)
    with torch.no_grad():
        ours, _ = transformer.forward_train(pc, _params(arch), _t(b))
        ours_loss, ours_aux = transformer.lm_loss(pc, _params(arch), _t(b))
    assert ours.shape == logits.shape
    _close(ours, logits)
    np.testing.assert_allclose(float(ours_loss), float(loss), **TOL)
    n_text = b["targets"].size
    assert int(ours_aux["n_tokens"]) == int(aux["n_tokens"]) == n_text
    if pc.vision_embed:
        assert ours.shape[1] == 16 + max(16 // 8, 1) == 16 + vision_prefix_len(pc, 16)


@pytest.mark.parametrize("pos_kind", ["scalar", "per-slot"])
def test_musicgen_prefill_and_decode_match_jax(pos_kind):
    """Prefill then three decode steps of codebook tokens, at one scalar
    position or a per-slot vector: logits (B, K, 1, V) and caches."""
    pc, jc = _cfgs("musicgen-medium")
    p = _jax_params("musicgen-medium")
    params = _params("musicgen-medium")
    codes = _batch("musicgen-medium")["codes"]
    max_len = S + STEPS + 1
    jcaches = jax_tf.init_caches(jc, B, max_len, jc.compute_dtype)
    jl, jcaches = jax_tf.prefill(jc, p, {"codes": jnp.asarray(codes)}, jcaches)
    with torch.no_grad():
        caches = transformer.init_caches(pc, B, max_len, pc.compute_dtype, "cpu")
        tl, caches = transformer.prefill(pc, params, {"codes": tensor_from_numpy(codes)}, caches)
    assert tl.shape == jl.shape == (B, pc.n_codebooks, 1, pc.vocab_size)
    _close(tl, jl)
    nxt = np.asarray(jnp.argmax(jl[..., -1, :], axis=-1), np.int32)  # (B, K)
    for i in range(STEPS):
        pos = (np.asarray(S + i, np.int32) if pos_kind == "scalar"
               else np.asarray([S + i, S - 3 + i], np.int32))
        step = {"codes": nxt[..., None]}
        jl, jcaches = jax_tf.decode_step(jc, p, {"codes": jnp.asarray(step["codes"])}, jcaches,
                                         jnp.asarray(pos))
        with torch.no_grad():
            tl, caches = transformer.decode_step(pc, params, {"codes": tensor_from_numpy(
                step["codes"])}, caches, tensor_from_numpy(pos))
        _close(tl, jl, tol=dict(rtol=2e-4, atol=2e-3))
        nxt = np.asarray(jnp.argmax(jl[..., -1, :], axis=-1), np.int32)
    for name in ("k", "v"):
        _close(caches[name], jcaches[name])


def test_qwen2vl_prefill_and_decode_with_positions_3d_match_jax():
    """The vision prefix prefills with the text; each decode step's M-RoPE
    angles come from its own ``positions_3d`` (B, 3, 1)."""
    pc, jc = _cfgs("qwen2-vl-72b")
    p = _jax_params("qwen2-vl-72b")
    params = _params("qwen2-vl-72b")
    b = _batch("qwen2-vl-72b", seq=16)
    prompt = {k: b[k] for k in ("tokens", "vision_embeds", "positions_3d")}
    total = b["positions_3d"].shape[-1]
    max_len = total + STEPS
    jcaches = jax_tf.init_caches(jc, B, max_len, jc.compute_dtype)
    jl, jcaches = jax_tf.prefill(jc, p, {k: jnp.asarray(v) for k, v in prompt.items()}, jcaches)
    with torch.no_grad():
        caches = transformer.init_caches(pc, B, max_len, pc.compute_dtype, "cpu")
        tl, caches = transformer.prefill(pc, params, _t(prompt), caches)
    _close(tl, jl)
    nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1), np.int32)
    for i in range(STEPS):
        pos = np.asarray([total + i, total - 2 + i], np.int32)
        # a grid-like id per plane, as an image patch would carry
        p3 = np.stack([pos, pos + 1, pos + 2 * i], axis=1)[..., None].astype(np.int32)
        step = {"tokens": nxt[:, None], "positions_3d": p3}
        jl, jcaches = jax_tf.decode_step(jc, p, {k: jnp.asarray(v) for k, v in step.items()},
                                         jcaches, jnp.asarray(pos))
        with torch.no_grad():
            tl, caches = transformer.decode_step(pc, params, _t(step), caches,
                                                 tensor_from_numpy(pos))
        _close(tl, jl)
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1), np.int32)
    for name in ("k", "v"):
        _close(caches[name], jcaches[name])


# ---------------------------------------------------------------------------
# synthetic batches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FRONTENDS + ("smollm-360m",))
def test_synthetic_batches_match_jax_layout(arch):
    """Keys, shapes and (port) dtypes of the three batch kinds, against the
    JAX package's batch for the same config."""
    cfg = get_smoke_config(arch)
    ours = synthetic_batch(cfg, SyntheticConfig(cfg.vocab_size, 24, 3, seed=0), 2)
    theirs = jax_batch(jax_smoke(arch), JaxSC(cfg.vocab_size, 24, 3, seed=0), 2)
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert tuple(ours[k].shape) == theirs[k].shape, k
        assert ours[k].is_contiguous()
    want = {"codes": torch.int64, "tokens": torch.int64, "targets": torch.int64,
            "vision_embeds": cfg.compute_dtype, "positions_3d": torch.int32}
    assert {k: v.dtype for k, v in ours.items()} == {k: want[k] for k in ours}


def test_synthetic_codebook_and_vision_draws():
    """Codes are the token stream broadcast over the codebooks modulo the
    vocabulary; the vision embeddings are drawn after the tokens (the token
    draws are those of a text config), N(0, 0.02^2); positions_3d is arange
    in all three planes."""
    mg, vl, text = (get_smoke_config(a) for a in ("musicgen-medium", "qwen2-vl-72b",
                                                   "smollm-360m"))
    sc = SyntheticConfig(vl.vocab_size, 64, 4, seed=9)
    plain = synthetic_batch(text, sc, 3)
    audio = synthetic_batch(mg, sc, 3)
    for k in range(mg.n_codebooks):
        assert torch.equal(audio["codes"][:, k], plain["tokens"] % mg.vocab_size)
        assert torch.equal(audio["targets"][:, k], plain["targets"] % mg.vocab_size)
    vis = synthetic_batch(vl, sc, 3)
    assert torch.equal(vis["tokens"], plain["tokens"])
    assert torch.equal(vis["targets"], plain["targets"])
    g = batch_generator(9, 3)
    torch.randint(1, sc.vocab_size, (4, 16), generator=g)
    torch.rand((4, 65), generator=g)
    torch.randint(1, sc.vocab_size, (4, 65), generator=g)
    want = (torch.randn((4, 8, vl.d_model), generator=g) * 0.02).to(vl.compute_dtype)
    assert torch.equal(vis["vision_embeds"], want)
    assert abs(float(vis["vision_embeds"].float().std()) - 0.02) < 0.003
    assert torch.equal(vis["positions_3d"],
                       torch.arange(72, dtype=torch.int32).expand(4, 3, 72))
    again = synthetic_batch(vl, sc, 3)
    assert all(torch.equal(vis[k], again[k]) for k in vis)


def test_disk_shards_carry_the_frontend_keys(tmp_path):
    """The disk data tier stores and returns every key of the new batches."""
    from repro_torch.core.spillstore import SpillStore
    from repro_torch.data.loader import DiskShardLoader, PrefetchLoader

    for arch in FRONTENDS:
        cfg = get_smoke_config(arch)
        sc_ = SyntheticConfig(cfg.vocab_size, 16, 2, seed=0)
        with SpillStore(str(tmp_path / arch), ephemeral=True) as store:
            loader = PrefetchLoader(
                DiskShardLoader.write_shards(store, lambda s: synthetic_batch(cfg, sc_, s), 2),
                device="cpu")
            for step in range(2):
                got, want = loader(step), synthetic_batch(cfg, sc_, step)
                assert got.keys() == want.keys()
                for k in want:
                    t = got[k]
                    assert t.dtype == want[k].dtype and torch.equal(t, want[k]), (arch, k)


# ---------------------------------------------------------------------------
# the schedule sweep
# ---------------------------------------------------------------------------


def test_schedcheck_sweep_covers_the_frontends():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        failures = sc._sweep()
    text = out.getvalue()
    assert failures == 0 and "skipped" not in text.replace("recurrentgemma", "")
    for arch in FRONTENDS:
        assert f"ok train {arch} expert_stream=0 budget=none" in text
        assert f"ok serve {arch} expert_stream=0 budget=none" in text
