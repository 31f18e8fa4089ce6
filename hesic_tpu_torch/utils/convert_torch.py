"""Reference PyTorch checkpoints -> the port's models.

The port's own copy of hesic_tpu/utils/convert_torch.py's numpy layout
converters (CompressAI v1.0.0 and the HESIC fork's state_dict names ->
the flax tree of the JAX package), composed with ``hesic_from_jax`` (that
tree -> the port's state_dict), so one converter per architecture serves
both packages:

  conv    torch (out, in, kh, kw)         -> HWIO (kh, kw, in, out)
  deconv  torch (in, out, kh, kw)         -> HWIO spatially flipped
  dense   torch (out, in)                 -> (in, out)
  GDN     beta (C,), gamma (C, C)         -> unchanged
  EntropyBottleneck  _matrices.{i}/_biases.{i}/_factors.{i}/quantiles
          -> matrix_{i}/bias_{i}/factor_{i}/quantiles

The homography net's first dense layer is fed the reference's NCHW
flatten; the tree's kernel rows are permuted to the NHWC flatten the port
shares with the JAX net (``convert_homography_net``).

``load_reference(model, payload, arch)`` loads a reference checkpoint
(``torch.load(..., weights_only=True)``: a state_dict, or a dict holding
one under ``state_dict``) into a port model, strictly.  ``main`` writes
the port's codec format (models/base.py ``CompressionModel.save``):

  python -m hesic_tpu_torch.utils.convert_torch ckpt.pth.tar --arch hesic \
      -o model.pkl

loadable by ``zoo.create_model(name, checkpoint="model.pkl")``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .persist import load_jax_tree


def _np(t):
    try:
        return t.detach().cpu().numpy()
    except AttributeError:
        return np.asarray(t)


def convert_conv(state: Dict, prefix: str) -> dict:
    out = {"kernel": _np(state[f"{prefix}.weight"]).transpose(2, 3, 1, 0)}
    if f"{prefix}.bias" in state:
        out["bias"] = _np(state[f"{prefix}.bias"])
    return out


def convert_deconv(state: Dict, prefix: str) -> dict:
    w = _np(state[f"{prefix}.weight"])  # (in, out, kh, kw)
    kernel = np.flip(w, (2, 3)).transpose(2, 3, 0, 1)  # (kh, kw, in, out)
    out = {"kernel": np.ascontiguousarray(kernel)}
    if f"{prefix}.bias" in state:
        out["bias"] = _np(state[f"{prefix}.bias"])
    return out


def convert_dense(state: Dict, prefix: str) -> dict:
    out = {"kernel": _np(state[f"{prefix}.weight"]).T}
    if f"{prefix}.bias" in state:
        out["bias"] = _np(state[f"{prefix}.bias"])
    return out


def convert_gdn(state: Dict, prefix: str) -> dict:
    return {"beta": _np(state[f"{prefix}.beta"]),
            "gamma": _np(state[f"{prefix}.gamma"])}


def convert_groupnorm(state: Dict, prefix: str) -> dict:
    return {"scale": _np(state[f"{prefix}.weight"]),
            "bias": _np(state[f"{prefix}.bias"])}


def convert_conv3d(state: Dict, prefix: str) -> dict:
    w = _np(state[f"{prefix}.weight"])  # (out, in, kd, kh, kw)
    return {"kernel": np.ascontiguousarray(w.transpose(2, 3, 4, 1, 0)),
            "bias": _np(state[f"{prefix}.bias"])}


def convert_entropy_bottleneck(state: Dict, prefix: str) -> dict:
    out = {"quantiles": _np(state[f"{prefix}.quantiles"])}
    i = 0
    while f"{prefix}._matrices.{i}" in state:
        out[f"matrix_{i}"] = _np(state[f"{prefix}._matrices.{i}"])
        out[f"bias_{i}"] = _np(state[f"{prefix}._biases.{i}"])
        if f"{prefix}._factors.{i}" in state:
            out[f"factor_{i}"] = _np(state[f"{prefix}._factors.{i}"])
        i += 1
    if i == 0:
        raise KeyError(f"no EntropyBottleneck params under '{prefix}'")
    return out


def _convert_sequential(state: Dict, torch_prefix: str, layer_kinds) -> dict:
    """layer_kinds: {index: 'conv'|'deconv'|'gdn'} for a torch Sequential."""
    out = {}
    for idx, kind in layer_kinds.items():
        sub = f"{torch_prefix}.{idx}"
        name = f"{torch_prefix.replace('.', '_')}_{idx}"
        if kind == "conv":
            out[name] = convert_conv(state, sub)
        elif kind == "deconv":
            out[name] = convert_deconv(state, sub)
        elif kind == "gdn":
            out[name] = convert_gdn(state, sub)
        else:
            raise ValueError(kind)
    return out


_GA_KINDS = {0: "conv", 1: "gdn", 2: "conv", 3: "gdn", 4: "conv", 5: "gdn",
             6: "conv"}
_GS_KINDS = {0: "deconv", 1: "gdn", 2: "deconv", 3: "gdn", 4: "deconv",
             5: "gdn", 6: "deconv"}


def convert_factorized(state: Dict) -> dict:
    params = {}
    params.update(_convert_sequential(state, "g_a", _GA_KINDS))
    params.update(_convert_sequential(state, "g_s", _GS_KINDS))
    params["entropy_bottleneck"] = convert_entropy_bottleneck(
        state, "entropy_bottleneck")
    return params


def convert_hyperprior(state: Dict) -> dict:
    """bmshj2018-hyperprior / mbt2018-mean (same sequential layout)."""
    params = convert_factorized(state)
    params.update(_convert_sequential(
        state, "h_a", {0: "conv", 2: "conv", 4: "conv"}))
    params.update(_convert_sequential(
        state, "h_s", {0: "deconv", 2: "deconv", 4: "conv"}))
    return params


def convert_mbt2018(state: Dict) -> dict:
    params = convert_hyperprior(state)
    params.update(_convert_sequential(
        state, "entropy_parameters", {0: "conv", 2: "conv", 4: "conv"}))
    params["context_prediction"] = convert_conv(state, "context_prediction")
    return params


# ---- cheng2020 (reference waseda.py:24-123) ----

def _res_unit(state: Dict, p: str) -> dict:
    return {"Conv_0": convert_conv(state, f"{p}.conv.0"),
            "Conv_1": convert_conv(state, f"{p}.conv.2"),
            "Conv_2": convert_conv(state, f"{p}.conv.4")}


def _res_block(state: Dict, p: str) -> dict:
    return {"Conv_0": convert_conv(state, f"{p}.conv1"),
            "Conv_1": convert_conv(state, f"{p}.conv2")}


def _res_block_stride(state: Dict, p: str) -> dict:
    out = {"Conv_0": convert_conv(state, f"{p}.conv1"),
           "Conv_1": convert_conv(state, f"{p}.conv2"),
           "GDN_0": convert_gdn(state, f"{p}.gdn")}
    if f"{p}.downsample.weight" in state:
        out["Conv_2"] = convert_conv(state, f"{p}.downsample")
    return out


def _res_block_upsample(state: Dict, p: str) -> dict:
    return {
        "SubpelConv3x3_0": {"Conv_0": convert_conv(state,
                                                   f"{p}.subpel_conv.0")},
        "Conv_0": convert_conv(state, f"{p}.conv"),
        "GDN_0": convert_gdn(state, f"{p}.igdn"),
        "SubpelConv3x3_1": {"Conv_0": convert_conv(state, f"{p}.upsample.0")},
    }


def _attention(state: Dict, p: str) -> dict:
    out = {}
    for i in range(3):
        out[f"_ResidualUnit_{i}"] = _res_unit(state, f"{p}.conv_a.{i}")
    for i in range(3):
        out[f"_ResidualUnit_{i + 3}"] = _res_unit(state, f"{p}.conv_b.{i}")
    out["Conv_0"] = convert_conv(state, f"{p}.conv_b.3")
    return out


_CHENG_BLOCK = {"rb": _res_block, "rbs": _res_block_stride,
                "rbu": _res_block_upsample, "attn": _attention}


def _convert_block_list(state: Dict, tname: str, kinds) -> dict:
    """kinds: list of 'conv'|'subpel'|'rb'|'rbs'|'rbu'|'attn'|None per
    torch Sequential index (None = parameterless activation)."""
    out = {}
    for i, kind in enumerate(kinds):
        if kind is None:
            continue
        p = f"{tname}.{i}"
        name = f"{tname}_{i}"
        if kind == "conv":
            out[name] = convert_conv(state, p)
        elif kind == "subpel":
            out[name] = {"Conv_0": convert_conv(state, f"{p}.0")}
        else:
            out[name] = _CHENG_BLOCK[kind](state, p)
    return out


def convert_cheng2020(state: Dict, attention: bool = False) -> dict:
    params = {}
    if attention:
        ga = ["rbs", "rb", "rbs", "attn", "rb", "rbs", "rb", "conv", "attn"]
        gs = ["attn", "rb", "rbu", "rb", "rbu", "attn", "rb", "rbu", "rb",
              "subpel"]
    else:
        ga = ["rbs", "rb", "rbs", "rb", "rbs", "rb", "conv"]
        gs = ["rb", "rbu", "rb", "rbu", "rb", "rbu", "rb", "subpel"]
    params.update(_convert_block_list(state, "g_a", ga))
    params.update(_convert_block_list(state, "g_s", gs))
    params.update(_convert_block_list(
        state, "h_a",
        ["conv", None, "conv", None, "conv", None, "conv", None, "conv"]))
    params.update(_convert_block_list(
        state, "h_s",
        ["conv", None, "subpel", None, "conv", None, "subpel", None,
         "conv"]))
    params.update(_convert_sequential(
        state, "entropy_parameters", {0: "conv", 2: "conv", 4: "conv"}))
    params["context_prediction"] = convert_conv(state, "context_prediction")
    params["entropy_bottleneck"] = convert_entropy_bottleneck(
        state, "entropy_bottleneck")
    return params


def convert_cheng2020_attn(state: Dict) -> dict:
    return convert_cheng2020(state, attention=True)


def _convert_stereo_coder(state: Dict, torch_name: str, flax_name: str,
                          kinds: Dict[int, str], out: dict):
    sub = {}
    for idx, kind in kinds.items():
        key = f"{torch_name}.{idx}"
        conv = {"conv": convert_conv, "deconv": convert_deconv,
                "gdn": convert_gdn}[kind]
        sub[f"{flax_name}_{idx}"] = conv(state, key)
    out[flax_name] = sub


def _hesic_enc(state: Dict, prefix: str) -> dict:
    """Encoder1 (newnet1.py:445-467 / newnet1_joint.py:460-482)."""
    return {
        "Conv_0": convert_conv(state, f"{prefix}.g_a_conv1"),
        "GDN_0": convert_gdn(state, f"{prefix}.g_a_gdn1"),
        "Conv_1": convert_conv(state, f"{prefix}.g_a_conv2"),
        "GDN_1": convert_gdn(state, f"{prefix}.g_a_gdn2"),
        "Conv_2": convert_conv(state, f"{prefix}.g_a_conv3"),
        "GDN_2": convert_gdn(state, f"{prefix}.g_a_gdn3"),
        "Conv_3": convert_conv(state, f"{prefix}.g_a_conv4"),
    }


def _hesic_dec(state: Dict, prefix: str) -> dict:
    return {
        "Deconv_0": convert_deconv(state, f"{prefix}.g_s_conv1"),
        "GDN_0": convert_gdn(state, f"{prefix}.g_s_gdn1"),
        "Deconv_1": convert_deconv(state, f"{prefix}.g_s_conv2"),
        "GDN_1": convert_gdn(state, f"{prefix}.g_s_gdn2"),
        "Deconv_2": convert_deconv(state, f"{prefix}.g_s_conv3"),
        "GDN_2": convert_gdn(state, f"{prefix}.g_s_gdn3"),
        "Deconv_3": convert_deconv(state, f"{prefix}.g_s_conv4"),
    }


def _hesic_enc2(state: Dict, prefix: str) -> dict:
    return {
        "Conv_0": convert_conv(state, f"{prefix}.pre_conv"),
        "GDN_0": convert_gdn(state, f"{prefix}.pre_gdn"),
        "Conv_1": convert_conv(state, f"{prefix}.g_a_conv1"),
        "GDN_1": convert_gdn(state, f"{prefix}.g_a_gdn1"),
        "Conv_2": convert_conv(state, f"{prefix}.g_a_conv2"),
        "GDN_2": convert_gdn(state, f"{prefix}.g_a_gdn2"),
        "Conv_3": convert_conv(state, f"{prefix}.g_a_conv3"),
        "GDN_3": convert_gdn(state, f"{prefix}.g_a_gdn3"),
        "Conv_4": convert_conv(state, f"{prefix}.g_a_conv4"),
    }


def _hesic_dec2(state: Dict, prefix: str) -> dict:
    out = _hesic_dec(state, prefix)
    out["GDN_3"] = convert_gdn(state, f"{prefix}.after_gdn")
    out["Deconv_4"] = convert_deconv(state, f"{prefix}.after_conv")
    return out


def convert_hesic(state: Dict) -> dict:
    """HESIC (HSIC, ywz/mywork/newnet1.py) -> the HESIC tree.

    The reference unrolls its encoder/decoder layers as individually-named
    conv/GDN attributes; map each onto the corresponding submodule of our
    StereoEncoder/StereoDecoder stacks (declared with @nn.compact, so the
    children are auto-named Conv_0/GDN_0/...).
    """
    params = {
        "encoder1": _hesic_enc(state, "encoder1"),
        "decoder1": _hesic_dec(state, "decoder1"),
        "encoder2": _hesic_enc2(state, "encoder2"),
        "decoder2": _hesic_dec2(state, "decoder2"),
        "entropy_bottleneck1": convert_entropy_bottleneck(
            state, "entropy_bottleneck1"),
        "entropy_bottleneck2": convert_entropy_bottleneck(
            state, "entropy_bottleneck2"),
    }
    # hyper encoders: Sequential inside a wrapper (encode_hyper)
    for tname, fname in (("_h_a1", "h_a1"), ("_h_a2", "h_a2")):
        params[fname] = {
            "Conv_0": convert_conv(state, f"{tname}.encode_hyper.0"),
            "Conv_1": convert_conv(state, f"{tname}.encode_hyper.2"),
            "Conv_2": convert_conv(state, f"{tname}.encode_hyper.4"),
        }
    # GMM hyper heads
    params["h_s1"] = _gmm_hyper_y1(state, "_h_s1")
    params["h_s2"] = _gmm_hyper_y2(state, "_h_s2")
    return params


def convert_hesic_plus(state: Dict) -> dict:
    """HESIC+ (newnet1_joint.py:586-673) -> the HESIC+ tree."""
    params = {
        "encoder1": _hesic_enc(state, "encoder1"),
        "decoder1": _hesic_dec(state, "decoder1"),
        "encoder2": _hesic_enc2(state, "encoder2"),
        "decoder2": _hesic_dec2(state, "decoder2"),
        "entropy_bottleneck1": convert_entropy_bottleneck(
            state, "entropy_bottleneck1"),
        "entropy_bottleneck2": convert_entropy_bottleneck(
            state, "entropy_bottleneck2"),
    }
    for eye in ("1", "2"):
        params.update(_convert_sequential(
            state, f"h_a{eye}", {0: "conv", 2: "conv", 4: "conv"}))
        params.update(_convert_sequential(
            state, f"h_s{eye}", {0: "deconv", 2: "deconv", 4: "conv"}))
        params.update(_convert_sequential(
            state, f"entropy_parameters{eye}",
            {0: "conv", 2: "conv", 4: "conv"}))
        params[f"context_prediction{eye}"] = convert_conv(
            state, f"context_prediction{eye}")
    return params


def _gmm_hyper_y1(state: Dict, p: str) -> dict:
    """gmm_hyper_y1 heads (newnet1.py:456-514 / mynet6.py:321-380)."""
    return {
        "Deconv_0": convert_deconv(state, f"{p}.gmm_sigma.0"),
        "Deconv_1": convert_deconv(state, f"{p}.gmm_sigma.2"),
        "Conv_0": convert_conv(state, f"{p}.gmm_sigma.4"),
        "Deconv_2": convert_deconv(state, f"{p}.gmm_means.0"),
        "Deconv_3": convert_deconv(state, f"{p}.gmm_means.2"),
        "Conv_1": convert_conv(state, f"{p}.gmm_means.4"),
        "Deconv_4": convert_deconv(state, f"{p}.gmm_weights.0"),
        "Deconv_5": convert_deconv(state, f"{p}.gmm_weights.2"),
        "Conv_2": convert_conv(state, f"{p}.gmm_weights.5"),
    }


def _gmm_hyper_y2(state: Dict, p: str) -> dict:
    return {
        "Conv_0": convert_conv(state, f"{p}.gmm_sigma.0"),
        "Conv_1": convert_conv(state, f"{p}.gmm_sigma.2"),
        "Conv_2": convert_conv(state, f"{p}.gmm_sigma.4"),
        "Conv_3": convert_conv(state, f"{p}.gmm_means.0"),
        "Conv_4": convert_conv(state, f"{p}.gmm_means.2"),
        "Conv_5": convert_conv(state, f"{p}.gmm_means.4"),
        "Conv_6": convert_conv(state, f"{p}.gmm_weights.0"),
        "Conv_7": convert_conv(state, f"{p}.gmm_weights.2"),
        "Conv_8": convert_conv(state, f"{p}.gmm_weights.5"),
    }


def _cost_volume(state: Dict, p: str) -> dict:
    """cost_volume (mynet6.py:185-249): 2-D branch, 3-D branch, head."""
    return {
        "Conv_0": convert_conv(state, f"{p}.model1.0"),
        "GroupNorm_0": convert_groupnorm(state, f"{p}.model1.1"),
        "Conv_1": convert_conv(state, f"{p}.model1.3"),
        "GroupNorm_1": convert_groupnorm(state, f"{p}.model1.4"),
        "Conv3D_0": convert_conv3d(state, f"{p}.model2.0"),
        "GroupNorm_2": convert_groupnorm(state, f"{p}.model2.1"),
        "Conv3D_1": convert_conv3d(state, f"{p}.model2.3"),
        "GroupNorm_3": convert_groupnorm(state, f"{p}.model2.4"),
        "Conv_2": convert_conv(state, f"{p}.model3.0"),
        "GroupNorm_4": convert_groupnorm(state, f"{p}.model3.1"),
        "Conv_3": convert_conv(state, f"{p}.model3.3"),
        "GroupNorm_5": convert_groupnorm(state, f"{p}.model3.4"),
        "Conv_4": convert_conv(state, f"{p}.model3.6"),
    }


def convert_dsic(state: Dict) -> dict:
    """DSIC (mynet6.py:552-701) -> the DSIC tree."""
    params = {
        "encoder1": _hesic_enc(state, "encoder1"),
        "decoder1": _hesic_dec(state, "decoder1"),
        "global_context": {
            "Conv_0": convert_conv(state, "_global_context.global_net.0"),
            "GroupNorm_0": convert_groupnorm(
                state, "_global_context.global_net.1"),
            "Conv_1": convert_conv(state, "_global_context.global_net.3"),
            "GroupNorm_1": convert_groupnorm(
                state, "_global_context.global_net.4"),
            "Conv_2": convert_conv(state, "_global_context.global_net.6"),
            "GroupNorm_2": convert_groupnorm(
                state, "_global_context.global_net.7"),
            "Conv_3": convert_conv(state, "_global_context.global_net.9"),
        },
        "h_s1": _gmm_hyper_y1(state, "_h_s1"),
        "h_s2": _gmm_hyper_y2(state, "_h_s2"),
        "entropy_bottleneck1": convert_entropy_bottleneck(
            state, "entropy_bottleneck1"),
        "entropy_bottleneck2": convert_entropy_bottleneck(
            state, "entropy_bottleneck2"),
    }
    for i in range(1, 7):
        params[f"cost_volume{i}"] = _cost_volume(state, f"_cost_volume{i}")
    for tname, fname in (("_h_a1", "h_a1"), ("_h_a2", "h_a2")):
        params[fname] = {
            "Conv_0": convert_conv(state, f"{tname}.encode_hyper.0"),
            "Conv_1": convert_conv(state, f"{tname}.encode_hyper.2"),
            "Conv_2": convert_conv(state, f"{tname}.encode_hyper.4"),
        }
    for stage, kind in (("g_a", convert_conv), ("g_s", convert_deconv)):
        for i in range(1, 5):
            params[f"pic2_{stage}_conv{i}"] = kind(
                state, f"pic2_{stage}_conv{i}")
            if i < 4:
                params[f"pic2_{stage}_gdn{i}"] = convert_gdn(
                    state, f"pic2_{stage}_gdn{i}")
    return params


def convert_homography_net(state: Dict, patch_size: int = 128) -> dict:
    """udh Net (udh/udh/model.py:53-98) -> the HomographyNet tree.

    The torch fc flattens NCHW (c-major); our NHWC flatten is hwc-major,
    so the first dense kernel's input rows are permuted accordingly.
    """
    p8 = patch_size // 8
    params = {}
    for i in range(4):
        params[f"_VGGBlock_{i}"] = {
            "Conv_0": convert_conv(state, f"cnn.{i}.layers.0"),
            "Conv_1": convert_conv(state, f"cnn.{i}.layers.2"),
        }
    w = _np(state["fc.2.weight"])                  # (1024, 128*p8*p8)
    w = w.reshape(-1, 128, p8, p8).transpose(2, 3, 1, 0)
    params["Dense_0"] = {
        "kernel": np.ascontiguousarray(w.reshape(p8 * p8 * 128, -1)),
        "bias": _np(state["fc.2.bias"]),
    }
    params["Dense_1"] = convert_dense(state, "fc.5")
    return params


def _enhancement(state: Dict, p: str, cross: bool) -> dict:
    """Enhancement head (newnet1.py:288-311 cross-view 6->32, or the
    DSIC+ single-view 3->32 variant mynet6_plus.py:56-78): conv1 +
    3 EnhancementBlocks of 3 ResidualBlocks + conv2.  The flax twin
    auto-names its children identically for both variants; `cross`
    validates which variant the checkpoint actually holds."""
    in_ch = state[f"{p}.conv1.weight"].shape[1]
    want = 6 if cross else 3
    if in_ch != want:
        raise ValueError(
            f"{p}.conv1 has {in_ch} input channels; expected {want} for "
            f"the {'cross-view' if cross else 'single-view'} Enhancement")
    out = {"Conv_0": convert_conv(state, f"{p}.conv1"),
           "Conv_1": convert_conv(state, f"{p}.conv2")}
    for i in range(3):
        out[f"EnhancementBlock_{i}"] = {
            f"ResidualBlock_{j}": _res_block(state, f"{p}.EB{i + 1}.RB{j + 1}")
            for j in range(3)}
    return out


def _independent_en(state: Dict, p: str, cross: bool) -> dict:
    """Independent_EN (newnet1.py:1278-1300 with homography warps;
    mynet6_plus.py:80-101 warp-free single-view)."""
    name = "Enhancement" if cross else "EnhancementSelf"
    return {f"{name}_0": _enhancement(state, f"{p}.EH1", cross),
            f"{name}_1": _enhancement(state, f"{p}.EH2", cross)}


def _sub_state(state: Dict, prefix: str) -> Dict:
    pre = prefix + "."
    return {k[len(pre):]: v for k, v in state.items()
            if k.startswith(pre)}


def convert_hesic_together(state: Dict) -> dict:
    """GMM_together (newnet1.py:1304-1321): m1 = HSIC,
    m2 = Independent_EN."""
    return {"m1": convert_hesic(_sub_state(state, "m1")),
            "m2": _independent_en(state, "m2", cross=True)}


def convert_hesic_plus_together(state: Dict) -> dict:
    """GMM_together (newnet1_joint.py:1351-1369): m1 = HESIC+."""
    return {"m1": convert_hesic_plus(_sub_state(state, "m1")),
            "m2": _independent_en(state, "m2", cross=True)}


def convert_dsic_plus(state: Dict) -> dict:
    """DSIC_plus (mynet6_plus.py:1352-1370): m1 = DSIC, m2 = warp-free
    single-view Independent_EN."""
    return {"m1": convert_dsic(_sub_state(state, "m1")),
            "m2": _independent_en(state, "m2", cross=False)}


ARCH_CONVERTERS = {
    "bmshj2018-factorized": convert_factorized,
    "bmshj2018-hyperprior": convert_hyperprior,
    "mbt2018-mean": convert_hyperprior,
    "mbt2018": convert_mbt2018,
    "cheng2020-anchor": convert_cheng2020,
    "cheng2020-attn": convert_cheng2020_attn,
    "hesic": convert_hesic,
    "hesic-together": convert_hesic_together,
    "hesic-plus": convert_hesic_plus,
    "hesic-plus-together": convert_hesic_plus_together,
    "dsic": convert_dsic,
    "dsic-plus": convert_dsic_plus,
    "homography-net": convert_homography_net,
}


def convert_state_dict(state_dict: Dict, arch: str) -> dict:
    """Convert a torch state_dict (possibly a checkpoint with 'state_dict')
    into the JAX package's param tree for `arch` (numpy leaves)."""
    if "state_dict" in state_dict and not any(
            "." in k for k in state_dict if k != "state_dict"):
        state_dict = state_dict["state_dict"]
    if arch not in ARCH_CONVERTERS:
        raise ValueError(f"no converter for '{arch}' "
                         f"(available: {sorted(ARCH_CONVERTERS)})")
    return ARCH_CONVERTERS[arch](state_dict)


def load_reference(model: torch.nn.Module, payload: Dict, arch: str) -> None:
    """Load a reference torch state_dict (or a checkpoint dict holding one)
    of architecture `arch` into `model`, in place on its device: every
    parameter must be carried, and nothing else."""
    load_jax_tree(model, convert_state_dict(payload, arch))


def read_reference(path: str) -> Dict:
    """A reference checkpoint file, read without unpickling code."""
    return torch.load(path, map_location="cpu", weights_only=True)


def build_for(arch: str, payload: Dict, quality=None, **overrides):
    """The port's codec on the CPU (the zoo's at `quality`, default its
    lowest; for ``homography-net`` the bare net) of `arch` at the
    checkpoint's own ``config`` widths and then `overrides`, its weights
    loaded."""
    config = dict(payload.get("config") or {}) if isinstance(
        payload, dict) else {}
    config.update(overrides)
    if arch == "homography-net":
        from ..geometry.net import HomographyNet
        net = HomographyNet(device="cpu", **config)
        load_reference(net, payload, arch)
        return net
    from ..zoo import cfgs, config_for, create_model, model_architectures
    codec = create_model(arch, quality or min(cfgs[arch]), device="cpu",
                         **config_for(model_architectures[arch][0], config))
    load_reference(codec.model, payload, arch)
    return codec


def main(argv=None) -> str:
    """CLI: reference torch checkpoint -> the port's codec format (the
    homography net's file for ``--arch homography-net``)."""
    import argparse

    parser = argparse.ArgumentParser(
        description="Convert a reference PyTorch checkpoint to the port's "
                    "format")
    parser.add_argument("checkpoint")
    parser.add_argument("--arch", required=True,
                        choices=sorted(ARCH_CONVERTERS))
    parser.add_argument("-o", "--output", required=True)
    args = parser.parse_args(argv)
    built = build_for(args.arch, read_reference(args.checkpoint))
    if args.arch == "homography-net":
        from ..training.train_homography import save_homography_net
        save_homography_net(built, args.output)
    else:
        built.save(args.output)
    print(args.output)
    return args.output


if __name__ == "__main__":
    main()
