from .options import configs_from_opt  # noqa: F401
