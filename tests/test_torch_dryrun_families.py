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


@pytest.mark.parametrize("ep", [True, False])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v3-671b"])
def test_moe_exchange_in_a_traced_step_is_the_formula(arch, kind, ep):
    """The all-to-alls of a traced step (``all_to_all_single``: the MoE
    layers' exchange alone) are ``dryrun.moe_exchange``'s count and bytes:
    the formula of ``models/moe.py`` times the layers' passes; in training
    at remat's full-size setting too (the reduced configs turn remat
    off)."""
    import dataclasses
    cfg = get_arch(arch).reduced()
    shape = ShapeConfig(kind, 32, 8, kind)

    class Mesh:
        axis_names, shape = ("data", "model"), {"data": 4, "model": 2}
    for c in (cfg, dataclasses.replace(cfg, remat=True))[:2 if kind == "train"
                                                          else 1]:
        rec = D.trace(c, shape, (4, 2), ("data", "model"), device="cpu",
                      variant={"ep": ep})
        got = rec["roofline"]["coll_by_op"].get("all_to_all_single")
        assert rec["status"] == "ok"
        assert got == D.moe_exchange(c, shape, Mesh, {"ep": ep}), (got, kind)
