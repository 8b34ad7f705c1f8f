"""EmbedVAE — the multi-level token-embedding autoencoder (the JAX
package's ``models/embed_vae.py``; the reference's EmbedVAE/VAE/MAEC,
src/Manifold/EmbedVAE.cpp, latent dims ``token_embeds``): the embedding
table goes through a stack of latent bottlenecks and back, so a model can
train and serve with low-dimensional embeddings (the LLAMA_VAE arch's
``embed_tokens``). Plain PyTorch, as the JAX module is XLA.

``train_embed_vae`` draws its batch indices from threefry keys as the JAX
package does (``utils/prng.py``: the same key gives the same rows), and
runs the same Adam-like update in f32.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from koifish_tpu_torch.utils import prng


def init_embed_vae(gen: torch.Generator, dims: Sequence[int],
                   dtype=torch.float32, device=None) -> Dict:
    """dims: [E, l1, l2, ...] — the encoder E -> l1 -> l2 ..., the decoder
    its mirror; weights normal / sqrt(fan-in), biases zero."""
    enc, dec = [], []

    def nrm(shape, s):
        return (torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32) * s).to(dtype)

    for i in range(len(dims) - 1):
        enc.append({"w": nrm((dims[i], dims[i + 1]), dims[i] ** -0.5),
                    "b": torch.zeros((dims[i + 1],), dtype=dtype,
                                     device=device)})
        dec.append({"w": nrm((dims[i + 1], dims[i]), dims[i + 1] ** -0.5),
                    "b": torch.zeros((dims[i],), dtype=dtype,
                                     device=device)})
    dec.reverse()
    return {"enc": enc, "dec": dec}


def _stack(layers: List[Dict], x: torch.Tensor) -> torch.Tensor:
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if i < len(layers) - 1:
            x = F.gelu(x, approximate="tanh")
    return x


def encode(vae: Dict, x: torch.Tensor) -> torch.Tensor:
    return _stack(vae["enc"], x)


def decode(vae: Dict, z: torch.Tensor) -> torch.Tensor:
    return _stack(vae["dec"], z)


def reconstruction_loss(vae: Dict, x: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(decode(vae, encode(vae, x)) - x))


def train_embed_vae(wte: torch.Tensor, dims: Sequence[int], steps: int = 200,
                    lr: float = 1e-3, batch: int = 1024,
                    key: Optional[np.ndarray] = None,
                    vae: Optional[Dict] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[Dict, List[float]]:
    """Fit the VAE to an embedding table [V, E]; returns (vae, loss curve).
    Step t's rows are ``randint`` under the second half of ``split(key)``,
    the key moving on to the first half, from ``key`` (None: PRNGKey(0)),
    as in the JAX package. The initial ``vae`` is drawn from ``generator``
    unless given (the JAX package draws it from the same key)."""
    key = prng.prng_key(0) if key is None else key
    dev = wte.device
    if vae is None:
        vae = init_embed_vae(generator, dims, device=dev)
    wte = wte.to(torch.float32)
    params = [p for layer in vae["enc"] + vae["dec"]
              for p in (layer["w"], layer["b"])]
    params = [p.detach().to(torch.float32).requires_grad_(True)
              for p in params]
    it = iter(params)
    vae = {part: [{"w": next(it), "b": next(it)} for _ in vae[part]]
           for part in ("enc", "dec")}
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    losses = []
    for t in range(1, steps + 1):
        key, k = prng.split(key)
        idx = torch.from_numpy(prng.randint(k, (batch,), 0, wte.shape[0]))
        loss = reconstruction_loss(vae, wte[idx.to(dev).long()])
        grads = torch.autograd.grad(loss, params)
        # 0.9**t and 0.99**t in f32, as the jitted JAX step takes them
        c1 = 1 - torch.tensor(0.9, dtype=torch.float32) ** t
        c2 = 1 - torch.tensor(0.99, dtype=torch.float32) ** t
        with torch.no_grad():
            for p, mm, vv, g in zip(params, m, v, grads):
                mm.mul_(0.9).add_(0.1 * g)
                vv.mul_(0.99).add_(0.01 * g * g)
                p.sub_(lr * (mm / c1.to(dev))
                       / (torch.sqrt(vv / c2.to(dev)) + 1e-8))
        losses.append(float(loss.detach()))
    with torch.no_grad():
        out = {part: [{k2: x.detach() for k2, x in layer.items()}
                      for layer in vae[part]] for part in ("enc", "dec")}
    return out, losses


def compress_embeddings(wte: torch.Tensor, vae: Dict) -> torch.Tensor:
    """Encode the whole table to the latent dim (storage / serving form)."""
    return encode(vae, wte.to(torch.float32))
