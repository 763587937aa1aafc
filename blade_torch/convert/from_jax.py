"""Weight bridge: the JAX package's flax parameter trees -> the port's state
dicts (diffusers key layout), with numpy only.

* :func:`wan_transformer_state_dict` inverts
  ``blade/convert/dit_convert.py::convert_wan_transformer``: flax
  ``kernel [in, out]`` -> torch ``weight [out, in]``, conv kernels
  ``[*k, in, out]`` -> ``[out, in, *k]``, the ``nn.scan`` layer axis split
  into ``blocks.{i}``.
  An I2V tree (``image_dim`` set) also gives the image embedder
  (``condition_embedder.image_embedder.*``) and each block's image branch
  (``attn2.add_k_proj``, ``add_v_proj``, ``norm_added_k``).
* :func:`wan_vae_state_dict` follows
  ``blade/convert/vae_convert.py::fake_torch_state_dict`` for the Wan VAE:
  the decode half (``decoder.*`` and ``post_quant_conv.*``) and, where the
  tree has them, the encode half (``encoder.*`` and ``quant_conv.*``).

* :func:`cogvideox_transformer_state_dict` inverts
  ``convert_cogvideox_transformer`` (diffusers
  ``CogVideoXTransformer3DModel`` keys), and
  :func:`cogvideox_vae_state_dict` follows ``fake_torch_state_dict`` for the
  CogVideoX VAE's decoder (``AutoencoderKLCogVideoX`` ``decoder.*`` keys).

* :func:`wan_lora_factors` and :func:`cogvideox_lora_factors` map
  ``blade/training/lora.py``'s LoRA factor tree over a flax ``WanModel`` or
  ``CogVideoXModel`` onto the port's adapter dict (``training/lora.py``),
  permuting the ``b`` columns of ``attn1.to_q`` / ``to_k`` into the port's
  stored (de-interleaved) row order.

Trees are nested dicts of arrays, optionally under a top-level ``"params"``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

__all__ = ["wan_transformer_state_dict", "wan_vae_state_dict", "wan_lora_factors",
           "cogvideox_transformer_state_dict", "cogvideox_vae_state_dict",
           "cogvideox_lora_factors", "to_torch"]


def _tree(params: Mapping) -> Mapping:
    return params["params"] if "params" in params else params


def _lin(sd: Dict, name: str, node: Mapping) -> None:
    sd[f"{name}.weight"] = np.asarray(node["kernel"], np.float32).T.copy()
    if "bias" in node:
        sd[f"{name}.bias"] = np.asarray(node["bias"], np.float32)


def _norm(sd: Dict, name: str, node: Mapping) -> None:
    sd[f"{name}.weight"] = np.asarray(node["scale"], np.float32)
    if "bias" in node:
        sd[f"{name}.bias"] = np.asarray(node["bias"], np.float32)


def _layer(tree: Mapping, i: int) -> Mapping:
    """Layer ``i``'s params from a scanned (stacked) or unrolled tree."""
    if "blocks" in tree:
        def pick(node):
            if isinstance(node, Mapping):
                return {k: pick(v) for k, v in node.items()}
            return np.asarray(node)[i]
        return pick(tree["blocks"])
    return tree[f"blocks_{i}"]


def wan_transformer_state_dict(params: Mapping, num_layers: int) -> Dict[str, np.ndarray]:
    """flax ``WanModel`` params -> diffusers ``WanTransformer3DModel`` keys."""
    p = _tree(params)
    sd: Dict[str, np.ndarray] = {}
    w = np.asarray(p["patch_embedding"]["kernel"], np.float32)  # [*k, in, out]
    sd["patch_embedding.weight"] = np.ascontiguousarray(np.moveaxis(w, (-1, -2), (0, 1)))
    sd["patch_embedding.bias"] = np.asarray(p["patch_embedding"]["bias"], np.float32)
    ce = "condition_embedder"
    _lin(sd, f"{ce}.text_embedder.linear_1", p["text_proj_1"])
    _lin(sd, f"{ce}.text_embedder.linear_2", p["text_proj_2"])
    _lin(sd, f"{ce}.time_embedder.linear_1", p["time_embed"]["Dense_0"])
    _lin(sd, f"{ce}.time_embedder.linear_2", p["time_embed"]["Dense_1"])
    _lin(sd, f"{ce}.time_proj", p["time_projection"])
    if "img_norm1" in p:
        ie = f"{ce}.image_embedder"
        _norm(sd, f"{ie}.norm1", p["img_norm1"])
        _lin(sd, f"{ie}.ff.net.0.proj", p["img_ff_1"])
        _lin(sd, f"{ie}.ff.net.2", p["img_ff_2"])
        _norm(sd, f"{ie}.norm2", p["img_norm2"])
    head = np.asarray(p["head_modulation"], np.float32)
    sd["scale_shift_table"] = head.reshape(1, 2, head.shape[-1])
    _lin(sd, "proj_out", p["proj_out"])
    for i in range(num_layers):
        lp, b = _layer(p, i), f"blocks.{i}"
        mod = np.asarray(lp["modulation"], np.float32)
        sd[f"{b}.scale_shift_table"] = mod.reshape(1, 6, mod.shape[-1])
        for attn in ("attn1", "attn2"):
            for proj in ("to_q", "to_k", "to_v"):
                _lin(sd, f"{b}.{attn}.{proj}", lp[attn][proj])
            _lin(sd, f"{b}.{attn}.to_out.0", lp[attn]["to_out"])
            _norm(sd, f"{b}.{attn}.norm_q", lp[attn]["norm_q"])
            _norm(sd, f"{b}.{attn}.norm_k", lp[attn]["norm_k"])
        if "add_k_proj" in lp["attn2"]:
            for proj in ("add_k_proj", "add_v_proj"):
                _lin(sd, f"{b}.attn2.{proj}", lp["attn2"][proj])
            _norm(sd, f"{b}.attn2.norm_added_k", lp["attn2"]["norm_added_k"])
        _norm(sd, f"{b}.norm2", lp["norm3"])
        _lin(sd, f"{b}.ffn.net.0.proj", lp["ffn"]["Dense_0"])
        _lin(sd, f"{b}.ffn.net.2", lp["ffn"]["Dense_1"])
    return sd


def _conv_weight(node: Mapping) -> np.ndarray:
    """flax conv kernel ``[*k, in, out]`` -> torch ``[out, in, *k]``."""
    w = np.asarray(node["kernel"], np.float32)
    return np.ascontiguousarray(np.moveaxis(w, (-1, -2), (0, 1)))


def cogvideox_transformer_state_dict(params: Mapping, num_layers: int
                                     ) -> Dict[str, np.ndarray]:
    """flax ``CogVideoXModel`` params -> diffusers
    ``CogVideoXTransformer3DModel`` keys."""
    p = _tree(params)
    sd: Dict[str, np.ndarray] = {
        "patch_embed.proj.weight": _conv_weight(p["patch_embed"]),
        "patch_embed.proj.bias": np.asarray(p["patch_embed"]["bias"], np.float32),
    }
    _lin(sd, "patch_embed.text_proj", p["text_proj"])
    _lin(sd, "time_embedding.linear_1", p["time_embed_1"])
    _lin(sd, "time_embedding.linear_2", p["time_embed_2"])
    _norm(sd, "norm_final", p["norm_final"])
    _norm(sd, "norm_out.norm", p["norm_out"])
    _lin(sd, "norm_out.linear", p["norm_out_linear"])
    _lin(sd, "proj_out", p["proj_out"])
    for i in range(num_layers):
        lp, b = _layer(p, i), f"transformer_blocks.{i}"
        for norm in ("norm1", "norm2"):
            _lin(sd, f"{b}.{norm}.linear", lp[norm]["linear"])
            _norm(sd, f"{b}.{norm}.norm", lp[norm]["norm"])
        for proj in ("to_q", "to_k", "to_v"):
            _lin(sd, f"{b}.attn1.{proj}", lp["attn1"][proj])
        _lin(sd, f"{b}.attn1.to_out.0", lp["attn1"]["to_out"])
        _norm(sd, f"{b}.attn1.norm_q", lp["attn1"]["norm_q"])
        _norm(sd, f"{b}.attn1.norm_k", lp["attn1"]["norm_k"])
        _lin(sd, f"{b}.ff.net.0.proj", lp["ff"]["Dense_0"])
        _lin(sd, f"{b}.ff.net.2", lp["ff"]["Dense_1"])
    return sd


def _lora_factors(lora: Mapping, num_layers: int, num_heads: int, blocks: str,
                  attns) -> Dict[str, np.ndarray]:
    """flax LoRA tree -> ``{"<blocks>.{i}.{attn}.{proj}.a": [in, r], ".b":
    [r, out]}`` for the attentions ``attns`` of every block."""
    from blade_torch.models.layers import deinterleave_perm

    p = _tree(lora)
    out: Dict[str, np.ndarray] = {}
    for i in range(num_layers):
        lp = p["blocks"] if "blocks" in p else p[f"blocks_{i}"]
        for attn in attns:
            for proj in ("to_q", "to_k", "to_v", "to_out"):
                node = lp[attn][proj]["kernel"]
                a, b = (np.asarray(node[f], np.float32) for f in ("a", "b"))
                if a.ndim == 3:  # stacked over layers
                    a, b = a[i], b[i]
                if attn == "attn1" and proj in ("to_q", "to_k"):
                    b = b[:, deinterleave_perm(num_heads, b.shape[1] // num_heads)]
                name = f"{blocks}.{i}.{attn}.{proj}" + (".0" if proj == "to_out" else "")
                out[f"{name}.a"] = np.ascontiguousarray(a)
                out[f"{name}.b"] = np.ascontiguousarray(b)
    return out


def wan_lora_factors(lora: Mapping, num_layers: int, num_heads: int) -> Dict[str, np.ndarray]:
    """flax LoRA tree (``init_lora`` over ``WanModel`` params) -> the port's
    factors ``{"blocks.{i}.{attn}.{proj}.a": [in, r], ".b": [r, out]}``.

    An unrolled tree (``blocks_{i}``) or a scanned one with stacked
    ``[L, ...]`` factors gives each block its own pair; a scanned tree whose
    factors have no layer axis (one pair shared by all layers) gives every
    block that pair.  ``attn1.to_q``/``to_k`` get ``b[:, perm]``, perm the
    ``deinterleave_perm`` that ``PermutedLinear`` applies to their rows.
    """
    return _lora_factors(lora, num_layers, num_heads, "blocks", ("attn1", "attn2"))


def cogvideox_lora_factors(lora: Mapping, num_layers: int, num_heads: int
                           ) -> Dict[str, np.ndarray]:
    """flax LoRA tree (``init_lora`` over ``CogVideoXModel`` params) -> the
    port's factors ``{"transformer_blocks.{i}.attn1.{proj}.a": [in, r],
    ".b": [r, out]}`` (CogVideoX has one attention a block).  Both tree
    forms as :func:`wan_lora_factors`; the ``b`` columns of ``to_q`` /
    ``to_k`` take the q/k de-interleave that
    :func:`cogvideox_transformer_state_dict` folds into the weights at
    load."""
    return _lora_factors(lora, num_layers, num_heads, "transformer_blocks", ("attn1",))


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


_LIST_CONTAINERS = ("down_blocks", "up_blocks", "resnets", "attentions",
                    "upsamplers", "downsamplers", "resample")
_CAUSAL = {"conv_in", "conv_out", "conv1", "conv2", "conv_shortcut", "time_conv",
           "quant_conv", "post_quant_conv"}
_DENSE_1X1 = {"to_qkv", "proj"}


def _split_index(seg: str) -> str:
    """``up_blocks_3`` -> ``up_blocks.3`` for the known list containers."""
    for c in _LIST_CONTAINERS:
        if seg.startswith(c + "_") and seg[len(c) + 1:].isdigit():
            return f"{c}.{seg[len(c) + 1:]}"
    return seg


def _torch_conv(kernel: np.ndarray) -> np.ndarray:
    nd = kernel.ndim
    return np.ascontiguousarray(np.transpose(kernel, (nd - 1, nd - 2) + tuple(range(nd - 2))))


def wan_vae_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    """flax ``WanVAE`` params -> ``AutoencoderKLWan`` keys (``decoder.*``,
    ``post_quant_conv.*``, and ``encoder.*``, ``quant_conv.*`` where the
    tree has the encoder)."""
    sd: Dict[str, np.ndarray] = {}
    for path, value in _flatten(_tree(params)):
        value = np.asarray(value, np.float32)
        segs = [_split_index(s) for s in path]
        leaf, parent = segs[-1], segs[-2] if len(segs) > 1 else ""
        if leaf == "gamma":
            images = any(s.startswith("attentions") for s in segs)
            sd[".".join(segs)] = value.reshape((-1, 1, 1) if images else (-1, 1, 1, 1))
        elif parent == "conv" and segs[-3] in _CAUSAL:
            key = ".".join(segs[:-2])
            sd[f"{key}.{'weight' if leaf == 'kernel' else 'bias'}"] = (
                _torch_conv(value) if leaf == "kernel" else value)
        elif parent in _DENSE_1X1:
            key = ".".join(segs[:-1])
            sd[f"{key}.{'weight' if leaf == 'kernel' else 'bias'}"] = (
                np.ascontiguousarray(value.T[..., None, None]) if leaf == "kernel"
                else value)
        elif leaf in ("kernel", "bias"):  # resample.1
            key = ".".join(segs[:-1])
            sd[f"{key}.{'weight' if leaf == 'kernel' else 'bias'}"] = (
                _torch_conv(value) if leaf == "kernel" else value)
        else:
            raise KeyError(f"unmapped Wan VAE param: {'/'.join(path)}")
    return sd


def cogvideox_vae_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    """flax ``CogVideoXVAE`` params -> ``AutoencoderKLCogVideoX`` keys of the
    decoder (``decoder.*``); encoder keys are dropped."""
    sd: Dict[str, np.ndarray] = {}
    for path, value in _flatten(_tree(params)):
        if path[0] != "decoder":
            continue
        value = np.asarray(value, np.float32)
        segs = [_split_index(s) for s in path]
        key, leaf = ".".join(segs[:-1]), segs[-1]
        if leaf == "kernel":  # causal convs' inner conv, upsampler conv, shortcut
            sd[f"{key}.weight"] = _torch_conv(value)
        elif leaf == "scale":
            sd[f"{key}.weight"] = value
        elif leaf == "bias":
            sd[f"{key}.bias"] = value
        else:
            raise KeyError(f"unmapped CogVideoX VAE param: {'/'.join(path)}")
    return sd


def to_torch(sd: Mapping[str, np.ndarray], device=None) -> Dict:
    """numpy state dict -> torch tensors (for ``load_state_dict``)."""
    import torch

    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in sd.items()}
