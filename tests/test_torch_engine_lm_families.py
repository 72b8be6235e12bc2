"""The token engine over the moe, ssm and hybrid LMs: the engine-pair tests
of ``test_torch_engine_lm.py`` (the reference engine against the port's
token engine and its embedding engine, on the same weights, in float32)
run on granite-moe-3b-a800m, mamba2-130m and zamba2-2.7b REDUCED.

Before the boundary the pooled embeddings and the logits of a
teacher-forced ``generate`` agree to 1e-5 relative; after it a Q16.16 word
differs by at most one unit (printed with ``-s``); retrieval, the doc cache
and the port's two engines' states agree exactly. A document's MoE
embedding depends on the batch it is ingested in (the experts' capacity
counts the batch's tokens), in both packages alike, so both ingest the
same batches.
"""
import pytest

from test_torch_engine_lm import (  # noqa: F401  (collected here too)
    make_pair, test_boundary_words_differ_by_at_most_one,
    test_embedding_engine_has_no_lm,
    test_generate_teacher_forced_matches_reference,
    test_pooled_embeddings_agree,
    test_retrieval_and_doc_cache_match_reference,
    test_token_engine_equals_embedding_engine_bit_for_bit)


@pytest.fixture(scope="module",
                params=["granite_moe_3b_a800m", "mamba2_130m", "zamba2_2_7b"])
def pair(request):
    return make_pair(request.param)
