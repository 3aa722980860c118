"""Language models of the port (reference: ``repro.models``), one family
per module, each an ``nn.Module`` holding its config; ``model_api``
dispatches on the config type."""
