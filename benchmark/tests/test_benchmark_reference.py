"""The plain reference against the measured program at a tiny size on the
CPU, both in float32 with the same seeded weights and inputs."""

import torch

from benchmark.reference import model as R
from benchmark.weights import make_weights


def _port(tiny):
    from bbdm_tpu_torch.config import dict2namespace
    from bbdm_tpu_torch.models import build_model

    specs = R.param_specs(tiny["model"])
    weights = make_weights(specs, 5, "cpu")
    model = build_model(dict2namespace(tiny).model, device="cpu")
    model.load_state_dict(weights, strict=True)
    return model, R.Params(weights), specs


def test_specs_are_the_programs_parameters(tiny):
    model, _, specs = _port(tiny)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: shape for k, (shape, _) in specs.items()}


def test_encode_sample_decode_match(tiny):
    model, P, _ = _port(tiny)
    ops, vq = R.Ops(), tiny["model"]["VQGAN"]["params"]
    g = torch.Generator().manual_seed(0)
    x = torch.rand(2, 3, 32, 32, generator=g) * 2 - 1
    with torch.no_grad():
        z = R.vq_encode(P, ops, x, vq)
        torch.testing.assert_close(model.encode(x), z, rtol=1e-4, atol=1e-4)
        noise = [torch.randn(z.shape, generator=g) for _ in range(model.noised_steps())]
        ref = R.sample_latent(P, ops, z, noise, tiny["model"])
        torch.testing.assert_close(model.p_sample_loop(z, noise=noise, clip_denoised=False), ref,
                                   rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(model.decode(ref),
                                   R.vq_decode(P, ops, R.vq_quantize(P, ref, vq), vq),
                                   rtol=1e-4, atol=1e-4)


def test_train_step_matches(tiny):
    model, P, _ = _port(tiny)
    model.train()
    g = torch.Generator().manual_seed(1)
    x, y = (torch.rand(2, 3, 32, 32, generator=g) * 2 - 1 for _ in range(2))
    t = torch.randint(0, 50, (2,), generator=g)
    noise = torch.randn(2, 3, 16, 16, generator=g)
    loss = model.loss(x, y, t=t, noise=noise)[0]
    loss.backward()
    names = [k for k in P.weights if k.startswith("unet.")]
    leaves = [P.weights[k].clone().requires_grad_() for k in names]
    ref = R.train_loss(R.Params({**P.weights, **dict(zip(names, leaves))}), R.Ops(), x, y, t,
                       noise, tiny["model"])
    ref.backward()
    torch.testing.assert_close(loss, ref, rtol=1e-5, atol=1e-6)
    params = dict(model.named_parameters())
    for k, leaf in zip(names, leaves):
        torch.testing.assert_close(params[k].grad, leaf.grad, rtol=1e-3, atol=1e-5)
