from .distributed import sharded_eval_ranking, sharded_ranking_metrics  # noqa: F401
from .ranking import desired_distributions, eval_ranking, ranking_metrics  # noqa: F401
