from multistgraph_tpu_torch.config.parser import Config, ConfigError, load_config

__all__ = ["Config", "ConfigError", "load_config"]
