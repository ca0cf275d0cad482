"""Runnable examples of the port's API: ``python -m
waveverify_torch.examples.<name>`` (basic_usage, watermark_strategies,
web_api_integration)."""
