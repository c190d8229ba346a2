"""The port's copy of ``llama_kotlin_tpu/tokenizer/``.

Tokenizers: SPM (sentencepiece-style byte BPE), GPT-2-style byte-level
BPE with per-model pretokenizer presets, and WPM (WordPiece).

Parity target: reference llama-vocab.cpp (llm_tokenizer_spm :190,
llm_tokenizer_bpe :355, llm_tokenizer_wpm :649), validated against the
reference's golden fixtures models/ggml-vocab-*.gguf(.inp/.out).
"""

from llama_kotlin_tpu_torch.tokenizer.vocab import Vocab, build_tokenizer  # noqa: F401
