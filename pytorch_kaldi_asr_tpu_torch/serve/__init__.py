"""The recognition server (the port's ``pytorch_kaldi_asr_tpu.recipes.serve``,
split by part): ``recognizer`` (attention mode: the bucketed KV-cached beam
search), ``hybrid`` (an AM and a decode graph, with true streaming),
``attention_stream`` (incremental partials of attention-mode sessions),
``batcher`` (request coalescing), ``sessions`` (streaming sessions and
request statistics) and ``http`` (the endpoints and the server loop).
recipes/serve.py is the command line."""
