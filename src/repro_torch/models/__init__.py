"""The LM model zoo of the port (serving path of the dense family):
``common`` (config and building blocks), ``attention`` and ``lm``."""
