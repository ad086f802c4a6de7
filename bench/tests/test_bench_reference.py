"""The plain references at a small size on the CPU: causality, agreement
with the port's plain path on the weights the benchmark makes, and refusal
of a model the reference does not compute.  The references import nothing
of the program; this test may."""
import ast
import copy
import json
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent / "src"))

from benchlib import cellrun, discover, weights  # noqa: E402

LLAMA_TINY = dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
                  num_key_value_heads=2, intermediate_size=128,
                  vocab_size=256, torch_dtype="float32")
LLAMA_PORT = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
              "d_ff": 128, "vocab_size": 256, "dtype": "float32"}
TINY = {"llama": (LLAMA_TINY, LLAMA_PORT)}


def tiny(name):
    with open(BENCH / "configs" / f"{name}.json") as f:
        cfg = json.load(f)
    small, port = TINY[cfg["reference"]]
    cfg.update(small)
    cfg["port"]["replace"].update(copy.deepcopy(port))
    return cfg


def built(name, seed=5):
    from repro_torch.models.transformer import Model
    cfg = tiny(name)
    arch = cellrun.port_arch(cfg)
    model = Model(arch, device="cpu")
    params, _ = weights.make(Model(arch, device="meta").init_params(), seed,
                             "cpu")
    model.adopt(params)
    return cfg, model, params, cellrun.reference_weights(model, params)


CONFIGS = ["llama-3-8b-1slot"]


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_imports_nothing_of_the_program(name):
    cfg = tiny(name)
    src = (BENCH / "reference" / f"{cfg['reference']}.py").read_text()
    tops = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops.add(node.module.split(".")[0])
    assert tops <= {"__future__", "torch", "math", "numpy"}, tops


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_is_causal(name):
    cfg, _, _, w = built(name)
    ref = discover.reference(cfg)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, 256, (40,), generator=g)
    a = ref.logits(cfg, w, toks, 0)
    toks2 = toks.clone()
    toks2[30:] = (toks2[30:] + 7) % 256
    b = ref.logits(cfg, w, toks2, 0)
    assert torch.equal(a[:30], b[:30])
    assert not torch.equal(a[30:], b[30:])


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_agrees_with_the_ports_plain_path(name):
    """Prefill then decode through the port's cache, float32 on the CPU
    (its plain versions), against the reference's one full pass."""
    cfg, model, params, w = built(name)
    ref = discover.reference(cfg)
    g = torch.Generator().manual_seed(2)
    prompt = torch.randint(0, 256, (24,), generator=g)
    with torch.no_grad():
        lg, caches = model.prefill(params, {"tokens": prompt[None]}, 64)
        got = [lg[0, -1]]
        toks = [int(lg[0, -1].argmax())]
        for i in range(6):
            lg, caches = model.decode_step(params, caches,
                                           torch.tensor([[toks[-1]]]),
                                           24 + i)
            got.append(lg[0, -1])
            toks.append(int(lg[0, -1].argmax()))
    seq = torch.cat([prompt, torch.tensor(toks[:-1])])
    want = ref.logits(cfg, w, seq, 23)
    assert torch.allclose(torch.stack(got), want, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("key,value", [
    ("attention_bias", True), ("mlp_bias", True),
    ("tie_word_embeddings", True),
    ("rope_scaling", {"type": "llama3", "factor": 8.0})])
def test_reference_refuses_a_model_it_does_not_compute(key, value):
    """A published model with biases, tied embeddings or scaled RoPE is
    another model: the reference refuses it rather than compute a
    different one."""
    cfg, _, _, w = built(CONFIGS[0])
    ref = discover.reference(cfg)
    with pytest.raises(NotImplementedError):
        ref.logits(dict(cfg, **{key: value}), w, torch.arange(8), 0)
