from .engine import (GenerationResult, generate, make_serve_fns,  # noqa: F401
                     serve_step_spec)
