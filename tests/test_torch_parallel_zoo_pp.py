"""PyTorch port vs the JAX package: the model zoo under pipeline
parallelism, on a process mesh of 2 gloo ranks on the CPU (one spawn,
``tests/torch_dist_helpers.zoo_pp_worker``), against the JAX package's
1F1B pipeline step on its virtual CPU devices; the cards, helpers and
tolerances of ``tests/test_torch_parallel_zoo.py``, where the pipeline's
refusals are. Each tolerance is stated with the value measured beside it
(on this CPU)."""
import jax
import torch

from koifish_tpu.models import init_params as j_init_params

from koifish_tpu_torch.io.convert import params_from_numpy
from koifish_tpu_torch.parallel import pipeline as tpipeline

import torch_dist_helpers as dh
from test_torch_parallel_zoo import (_batches, _cards, _gate, _jax_pp,
                                     _one_rank, _run)
from torch_helpers import jax_tree_to_numpy, torch_threads


PP_ZOO = ("mamba", "salmon", "mla", "llama_vae")


def test_zoo_under_pp_trains_jaxs_curves(tmp_path):
    """Under pp 2 (1F1B, 4 micro-batches) the port trains MAMBA, SALMON,
    MLA and LLAMA_VAE on the JAX pipeline's curves (3 steps; measured loss
    gaps <= 1.4e-4, grad-norm gaps <= 2.9e-4): the JAX pipeline's own
    losses, the next-token CE for SALMON and LLAMA_VAE's embedding without
    its evae stack (ROADMAP.md queue 3), each stage reporting the same
    loss."""
    with torch_threads(1):
        res = _run(tmp_path, dh.zoo_pp_worker, PP_ZOO, _jax_pp)
    for name, (want, g0, g1) in res.items():
        assert g0 == g1, name
        _gate(f"pp {name}", want, g0)


def test_pp_losses_are_the_jax_pipelines_not_the_cards():
    """The quirk the pp curves mirror: the JAX pipeline's first loss is
    the next-token CE through ``gather_embed``, which for SALMON is not its
    diffusion loss and for LLAMA_VAE not its evae-embedded CE. The port's
    one-rank ``compute_loss`` gives the card's own loss, its pipeline the
    JAX pipeline's."""
    from koifish_tpu_torch.ops.cross_entropy import cross_entropy_loss
    from koifish_tpu_torch.train import trainer as ttrainer
    toks = torch.from_numpy(_batches(1)[0][0]).long()
    for i, name in enumerate(("salmon", "llama_vae")):
        jcard, card = _cards(name)
        init = jax_tree_to_numpy(j_init_params(jcard, jax.random.PRNGKey(i)))
        params = params_from_numpy(init, device="cpu")
        with torch.no_grad():
            own, _ = ttrainer.compute_loss(card, params, toks)
            st = tpipeline._Stage(card, _one_rank(), "pp", 16, "cpu")
            sl, other = tpipeline.stack_for_pipeline(params, 1, stage=0)
            y = st.apply(tpipeline._layers_of(sl, 2),
                         st.embed(other, toks[:, :-1]))
            pipe, _ = cross_entropy_loss(st.head(other, y), toks[:, 1:],
                                         None)
        print(name, "card's loss", float(own), "pipeline's", float(pipe))
        assert abs(float(own) - float(pipe)) > 1e-3
