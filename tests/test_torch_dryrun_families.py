"""The port's dry-run of every family (dense, MoE, xLSTM, hybrid, MLA,
enc-dec, VLM) at reduced size, each step kind traced as rank 0's program
on a fake 4 x 2 mesh (``FakeTensorMode`` over DTensor on a fake process
group; the plain versions on the CPU): each record ``ok``, its memory
consistent, its roofline counting flops, bytes and the collectives DTensor
issues, each kernel of the family's path counted, and no process group
left up.  A file of its own so that it runs beside test_torch_dryrun.py."""
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D

KERNELS = {
    "llama3.2-1b": {"flash_attention"}, "internvl2-1b": {"flash_attention"},
    "seamless-m4t-medium": {"flash_attention"},
    "qwen2-moe-a2.7b": {"flash_attention", "moe_topk"},
    "deepseek-v3-671b": {"flash_attention", "moe_topk"},
    "xlstm-350m": {"mlstm_scan"},
    "hymba-1.5b": {"flash_attention", "mlstm_scan"}}
BACKWARD = {"flash_attention": "flash_attention_bwd",
            "mlstm_scan": "mlstm_scan_bwd", "moe_topk": "moe_route_bwd"}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", list(KERNELS))
def test_trace_is_ok_for_every_family_on_a_fake_mesh(arch, kind):
    rec = D.trace(get_arch(arch).reduced(), ShapeConfig(kind, 32, 8, kind),
                  (4, 2), ("data", "model"), device="cpu")
    assert rec["status"] == "ok" and rec["kind"] == kind
    assert rec["n_devices"] == 8
    mem = rec["memory"]
    assert 0 < mem["argument_bytes"] < mem["peak_bytes"]
    assert mem["temp_bytes"] == mem["peak_bytes"] - mem["argument_bytes"]
    assert mem["output_bytes"] > 0
    r = rec["roofline"]
    assert r["flops"] > 0 and r["hbm_bytes"] > 0 and r["coll_bytes"] > 0
    assert sum(r["coll_counts"].values()) > 0
    want = set(KERNELS[arch])
    if kind == "decode":          # K2 in place of K1; xLSTM's steps no scan
        want = ({"decode_attention"} if "flash_attention" in want else set()) \
            | (want & {"moe_topk"})
        if arch == "deepseek-v3-671b":
            want = {"moe_topk"}   # MLA's decode attends in plain products
        if arch == "seamless-m4t-medium":
            want = {"decode_attention", "flash_attention"}    # cross layers
    if kind == "train":
        want |= {BACKWARD[k] for k in want}
    assert set(r["kernels"]) == want
    assert not torch.distributed.is_initialized()
