"""The port's command-line tools (port of ``llama_kotlin_tpu/tools/``): tokenize, simple, main."""
