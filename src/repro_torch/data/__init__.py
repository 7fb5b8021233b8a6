from .synthetic_lm import SyntheticLM  # noqa: F401
