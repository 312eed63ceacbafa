"""Models of the port: the paper's classic iterative-convergent models
(``classic``) and the served LM families (``ssm``, ``transformer``,
bundled by ``get_model``)."""
from repro_torch.models.api import ModelOps, get_model

__all__ = ["get_model", "ModelOps"]
