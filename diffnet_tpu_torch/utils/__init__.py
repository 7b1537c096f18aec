from .precond import ilu_from_operator, load_ilu_mat

__all__ = ["load_ilu_mat", "ilu_from_operator"]
