"""The JAX package's LM params without its eager draw, for the port's tests
that feed them to the reference: ``repro.models.model.init_params(cfg,
PRNGKey(0))`` is drawn by the port's ``init_params``, which
``test_torch_lm_model.py`` and ``test_torch_lm_families.py`` hold bit-equal
to the reference's eager draw on every smoke config. An eager JAX draw
compiles a threefry for each leaf shape, seconds an arch on this CPU."""
import jax
import jax.numpy as jnp

from repro_torch import convert
from repro_torch import random as t_random
from repro_torch.models import model as TM


# ``compiler_options`` for the reference's jits in the LM tests: LLVM at -O0
# compiles the same XLA program (every HLO pass still runs) in about half the
# CPU seconds; it moves float results by ulps, far inside the tests'
# tolerances, so bit-for-bit holds keep the default.
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def reference_params(cfg):
    """``cfg`` (the port's config) -> the reference's ``init_params(cfg,
    PRNGKey(0))`` tree of jnp float32 arrays."""
    params = TM.init_params(cfg, t_random.PRNGKey(0), device="cpu")
    return jax.tree.map(jnp.asarray, convert.lm_params_to_numpy(params))


def reference_state(cfg, jo):
    """The reference's ``train_step.init_state(cfg, jo, PRNGKey(0))`` with
    :func:`reference_params` as its params."""
    from repro.train import optimizer as JO

    params = reference_params(cfg)
    return {"params": params, "opt": JO.opt_init(params, jo),
            "step": jnp.zeros((), jnp.int32)}
