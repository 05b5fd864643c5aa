from llama_pipeline_parallel_tpu_torch.data.tokenization import (  # noqa: F401
    expand_special_tokenizer,
    is_seq2seq_tokenizer,
    tokenizer_get_name,
)
