"""Expert models as functions over plain parameter dicts / dataclasses."""
