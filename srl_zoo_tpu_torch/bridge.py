"""Weight bridge: a JAX run's weights as the port's state dict.

``state_dict_from_jax`` maps the JAX package's nested ``params`` /
``batch_stats`` dicts (numpy leaves) onto :class:`SRLModules`:

    params/encoder/Conv_i/kernel          HWIO -> encoder.convs.i.weight OIHW
                                             (CustomCNN)
    params/{encoder,decoder}/BatchNorm_i/scale,bias -> *.bns.i.weight,bias
    batch_stats/{encoder,decoder}/BatchNorm_i/mean,var
                                          -> *.bns.i.running_mean,var
    params/{encoder,decoder}/Dense_0/kernel,bias (in,out)
                                          -> *.fc.weight (out,in),bias
    params/decoder/ConvTranspose_i/kernel (kh,kw,in,out)
                     -> decoder.deconvs.i.weight (in,out,kh,kw), flipped on
                        both spatial axes (models/decoders.py)
    params/decoder/ConvTranspose_i/bias   -> decoder.deconvs.i.bias
    params/{forward,inverse,reward}_model/Dense_i/kernel,bias (in,out)
                                          -> *_model.layers.i.weight,bias
    params/discriminator/Dense_i/kernel,bias (in,out)
                                  -> discriminator.layers.i.weight,bias

A ResNet-18 encoder (models/resnet.py, torchvision's names) maps as

    params/encoder/Conv_0, BatchNorm_0    -> encoder.conv1, encoder.bn1
    params/encoder/BasicBlock_i/Conv_0, BatchNorm_0
                              -> encoder.layer{i//2+1}.{i%2}.conv1, bn1
    params/encoder/BasicBlock_i/Conv_1, BatchNorm_1   -> ...conv2, bn2
    params/encoder/BasicBlock_i/Conv_2, BatchNorm_2   -> ...downsample.0, .1

with the same kernel and BatchNorm conversions; the stem's kernel is one
``Conv_0/kernel`` for either JAX stem ("direct" or "s2d").
The VAE's encoder Dense_0 is 2 * state_dim wide (mu, then logvar).
Keys of subtrees the port does not know come back as a list of skipped
keys; a run of any loss of the zoo skips none. Convert a run folder in
place:

    python -m srl_zoo_tpu_torch.bridge --log-folder logs/<run>

reads ``srl_model.msgpack`` (flax's serialization, decoded here without
flax) and writes ``srl_model.pth`` beside it. Only this CLI needs
``msgpack``.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from srl_zoo_tpu_torch.config import SRLConfig
from srl_zoo_tpu_torch.models.decoders import WIDTHS as DECODER_WIDTHS
from srl_zoo_tpu_torch.models.decoders import deconv_weight_from_flax
from srl_zoo_tpu_torch.models.encoders import KERNEL_SIZES
from srl_zoo_tpu_torch.models.resnet import BLOCKS_PER_LAYER, WIDTHS

_MSGPACK_NDARRAY = 1  # flax's ext type: packed (shape, dtype name, C bytes)
HEADS = ("forward_model", "inverse_model", "reward_model", "discriminator")


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def _take_bn(sd: Dict[str, torch.Tensor], take, bn: str, jax_name: str
             ) -> None:
    sd[f"{bn}.weight"] = take(f"params/{jax_name}/scale")
    sd[f"{bn}.bias"] = take(f"params/{jax_name}/bias")
    sd[f"{bn}.running_mean"] = take(f"batch_stats/{jax_name}/mean")
    sd[f"{bn}.running_var"] = take(f"batch_stats/{jax_name}/var")
    sd[f"{bn}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def state_dict_from_jax(params: Dict, batch_stats: Dict
                        ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """(state dict of SRLModules, skipped JAX keys)."""
    flat = {f"params/{k}": v for k, v in _flatten(params).items()}
    flat.update({f"batch_stats/{k}": v
                 for k, v in _flatten(batch_stats).items()})

    def take(key: str) -> torch.Tensor:
        if key not in flat:
            raise KeyError(f"JAX weights lack '{key}'")
        return torch.from_numpy(np.array(flat.pop(key), np.float32))

    def conv(dst: str, jax_name: str) -> None:
        sd[f"{dst}.weight"] = take(
            f"params/{jax_name}/kernel").permute(3, 2, 0, 1).contiguous()

    sd: Dict[str, torch.Tensor] = {}
    if "params/encoder/BasicBlock_0/Conv_0/kernel" in flat:  # ResNet-18
        conv("encoder.conv1", "encoder/Conv_0")
        _take_bn(sd, take, "encoder.bn1", "encoder/BatchNorm_0")
        for i in range(len(WIDTHS) * BLOCKS_PER_LAYER):
            port = f"encoder.layer{i // BLOCKS_PER_LAYER + 1}." \
                   f"{i % BLOCKS_PER_LAYER}"
            src = f"encoder/BasicBlock_{i}"
            for j, (c, bn) in enumerate((("conv1", "bn1"), ("conv2", "bn2"),
                                         ("downsample.0", "downsample.1"))):
                if j < 2 or f"params/{src}/Conv_{j}/kernel" in flat:
                    conv(f"{port}.{c}", f"{src}/Conv_{j}")
                    _take_bn(sd, take, f"{port}.{bn}", f"{src}/BatchNorm_{j}")
    else:
        for i in range(len(KERNEL_SIZES)):
            conv(f"encoder.convs.{i}", f"encoder/Conv_{i}")
            _take_bn(sd, take, f"encoder.bns.{i}", f"encoder/BatchNorm_{i}")
    sd["encoder.fc.weight"] = take("params/encoder/Dense_0/kernel").T.contiguous()
    sd["encoder.fc.bias"] = take("params/encoder/Dense_0/bias")
    if "params/decoder/Dense_0/kernel" in flat:
        sd["decoder.fc.weight"] = take(
            "params/decoder/Dense_0/kernel").T.contiguous()
        sd["decoder.fc.bias"] = take("params/decoder/Dense_0/bias")
        for i in range(len(DECODER_WIDTHS) + 1):
            d = f"decoder.deconvs.{i}"
            sd[f"{d}.weight"] = deconv_weight_from_flax(
                take(f"params/decoder/ConvTranspose_{i}/kernel"))
            sd[f"{d}.bias"] = take(f"params/decoder/ConvTranspose_{i}/bias")
        for i in range(len(DECODER_WIDTHS)):
            _take_bn(sd, take, f"decoder.bns.{i}", f"decoder/BatchNorm_{i}")
    for head in HEADS:
        i = 0
        while f"params/{head}/Dense_{i}/kernel" in flat:
            sd[f"{head}.layers.{i}.weight"] = take(
                f"params/{head}/Dense_{i}/kernel").T.contiguous()
            sd[f"{head}.layers.{i}.bias"] = take(
                f"params/{head}/Dense_{i}/bias")
            i += 1
    unknown = [k for k in flat
               if k.split("/")[1] in ("encoder", "decoder") + HEADS]
    if unknown:
        raise KeyError(f"weights the port does not know: {unknown}")
    return sd, sorted(flat)


def read_flax_msgpack(path: str) -> Dict:
    """Decode a ``flax.serialization.to_bytes`` file of array leaves into
    nested dicts of numpy arrays (leaves over 1 GiB, which flax splits into
    chunks, do not occur in an encoder)."""
    import msgpack

    def ndarray(data: bytes) -> np.ndarray:
        shape, dtype, buf = msgpack.unpackb(data, raw=True)
        if dtype == b"bfloat16":
            raise ValueError("bfloat16 weights are not supported")
        return np.frombuffer(buf, dtype=np.dtype(dtype.decode())
                             ).reshape(shape).copy()

    def ext_hook(code: int, data: bytes):
        if code == _MSGPACK_NDARRAY:
            return ndarray(data)
        raise ValueError(f"unsupported msgpack ext type {code} in {path}")

    with open(path, "rb") as f:
        return msgpack.unpackb(f.read(), ext_hook=ext_hook, raw=False,
                               strict_map_key=False)


def convert_run(log_folder: str) -> Tuple[str, List[str]]:
    """srl_model.msgpack -> srl_model.pth in ``log_folder``; returns (path,
    skipped keys). The result is loaded into the config's model before it
    is written, so a shape mismatch fails here."""
    from srl_zoo_tpu_torch.checkpoint import MODEL_FILE, write_state_dict
    from srl_zoo_tpu_torch.models.srl_modules import SRLModules

    cfg = SRLConfig.load(log_folder)
    tree = read_flax_msgpack(os.path.join(log_folder, "srl_model.msgpack"))
    sd, skipped = state_dict_from_jax(tree["params"],
                                      tree.get("batch_stats", {}))
    SRLModules(cfg).load_state_dict(sd)
    path = os.path.join(log_folder, MODEL_FILE)
    write_state_dict(path, sd)
    return path, skipped


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description="Convert a JAX run's "
                                            "srl_model.msgpack to srl_model.pth")
    p.add_argument("--log-folder", type=str, required=True)
    args = p.parse_args(argv)
    path, skipped = convert_run(args.log_folder)
    print(f"wrote {path}")
    if skipped:
        print(f"skipped {len(skipped)} keys the port does not run yet: "
              + ", ".join(skipped))
    return path


if __name__ == "__main__":
    main()
