"""Metric parity vs the ACTUAL reference implementations (imported from
/root/reference with service deps stubbed):

- chartqa relaxed_correctness  (tasks/chartqa/utils.py:25)
- EvalAI VQA answer processor   (tasks/_task_utils/vqa_eval_metric.py)
- ANLS                          (api/metrics.py:298)
- MME parse_pred_ans            (tasks/mme/utils.py)
"""

import importlib.util
import sys
import types

import pytest

from lavida_mod.eval import filters as F
from lavida_mod.eval import metrics as M


def _load(path, name, extra_stubs=(), extra_modules=None):
    stubs = {}
    loguru = types.ModuleType("loguru")
    loguru.logger = types.SimpleNamespace(
        info=lambda *a, **k: None, warning=lambda *a, **k: None,
        error=lambda *a, **k: None, debug=lambda *a, **k: None)
    stubs["loguru"] = loguru
    fu = types.ModuleType("lmms_eval.tasks._task_utils.file_utils")
    fu.generate_submission_file = lambda *a, **k: "/tmp/sub.json"
    for mn in ("lmms_eval", "lmms_eval.tasks",
               "lmms_eval.tasks._task_utils"):
        stubs[mn] = types.ModuleType(mn)
    stubs["lmms_eval.tasks._task_utils.file_utils"] = fu
    for mn in extra_stubs:
        stubs[mn] = types.ModuleType(mn)
    stubs.update(extra_modules or {})
    if "lmms_eval.api.registry" in stubs:
        reg = stubs["lmms_eval.api.registry"]
        reg.register_aggregation = lambda *a, **k: (lambda f: f)
        reg.register_metric = lambda *a, **k: (lambda f: f)
    saved = {k: sys.modules.get(k) for k in stubs}
    sys.modules.update(stubs)
    try:
        spec = importlib.util.spec_from_file_location(name, path)
        m = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(m)
        return m
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


REF = "/root/reference/eval/lmms_eval"


def test_relaxed_accuracy_matches_chartqa_reference():
    ref = _load(f"{REF}/tasks/chartqa/utils.py", "ref_chartqa")
    cases = [
        ("12", "12"), ("12.0", "12"), ("12.5", "12"), ("12.7", "12"),
        ("100", "104"), ("100", "106"), ("0.04", "0.0405"),
        ("yes", "yes"), ("Yes", "yes"), ("yes", "no"),
        ("14%", "14"), ("14", "14%"), ("-20", "-21"), ("0", "0"),
        ("1,000", "1000"), ("3.50", "3.5 "),
    ]
    for pred, tgt in cases:
        ours = M.relaxed_accuracy(pred, tgt)
        theirs = float(ref.relaxed_correctness(pred, tgt))
        assert ours == theirs, (pred, tgt, ours, theirs)


def test_vqa_normalization_matches_evalai_processor():
    ref = _load(f"{REF}/tasks/_task_utils/vqa_eval_metric.py", "ref_vqa")
    proc = ref.EvalAIAnswerProcessor()
    cases = [
        "it's a cat", "Two.", "ten dogs", "a  lot of   people",
        "isnt that right", "1,000,000", "semi-colon; test",
        "don't know", "YES", "an apple", "the answer",
    ]
    for s in cases:
        assert M.vqa_normalize(s) == proc(s), s


def test_anls_matches_reference():
    ref = _load(f"{REF}/api/metrics.py", "ref_metrics",
                extra_stubs=("sacrebleu", "lmms_eval.api",
                             "lmms_eval.api.registry"))
    cases = [
        (["forty two"], "forty two"),
        (["forty two", "42"], "fourty two"),
        (["hello world"], "helo world"),
        (["abc"], "xyz"),
        (["  spaced   out "], "spaced out"),
        ([""], ""),
        (["long answer here"], "short"),
    ]
    for refs, pred in cases:
        ours = M.anls(pred, refs)
        theirs = ref.anls(refs, [pred])["anls"]
        assert abs(ours - theirs) < 1e-9, (refs, pred, ours, theirs)


def test_mme_parse_matches_reference():
    ref = _load(f"{REF}/tasks/mme/utils.py", "ref_mme")
    cases = [
        "yes", "Yes.", "no", "NO", "it is yes", "maybe",
        "Yes, the image shows a cat.", "no it does not", "",
        "The answer is no.",
    ]
    for s in cases:
        assert F.mme_parse_pred_ans(s) == ref.parse_pred_ans(s), s


def test_vqav2_accuracy_matches_reference():
    vem = _load(f"{REF}/tasks/_task_utils/vqa_eval_metric.py",
                "ref_vem")
    ref = _load(
        f"{REF}/tasks/vqav2/utils.py", "ref_vqav2",
        extra_modules={
            "lmms_eval.tasks._task_utils.vqa_eval_metric": vem})
    cases = [
        ("Yes.", ["yes"] * 10),
        ("yes", ["yes"] * 10),
        ("2", ["two", "2", "2", "two", "3", "2", "2", "two", "2", "2"]),
        ("a cat", ["cat", "the cat", "cat", "cat", "dog", "cat", "cat",
                   "cat", "cat", "kitten"]),
        ("don't know", ["dont know", "no idea", "dont know", "dont know",
                        "unknown", "dont know", "dont know", "dont know",
                        "dont know", "dont know"]),
        ("TEN", ["10"] * 10),
    ]
    for pred, answers in cases:
        doc = {"question_id": 0,
               "answers": [{"answer": a, "answer_id": i}
                           for i, a in enumerate(answers)]}
        theirs = ref.vqav2_process_results(doc, [pred])["exact_match"]
        ours = M.vqa_accuracy(pred, answers)
        assert abs(ours - theirs) < 1e-9, (pred, ours, theirs)


def test_pope_scoring_matches_reference():
    ref = _load(f"{REF}/tasks/pope/utils.py", "ref_pope")
    from lavida_mod.eval.tasks import _pope_score

    preds = ["yes", "Yes.", "no", "Yes, it is.", "NO", "maybe", "yes"]
    gts = ["yes", "yes", "no", "no", "yes", "no", "no"]
    ref_rows, our_rows = [], []
    for qid, (p, g) in enumerate(zip(preds, gts)):
        r = ref.pope_process_results(
            {"question_id": qid, "answer": g}, [p])
        ref_rows.append(r["pope_accuracy"])
        our_rows.append(_pope_score({"target": g, "id": qid}, p))
    agg = M.pope_aggregate(our_rows)
    assert agg["accuracy"] == ref.pope_aggregate_accuracy(ref_rows)
    assert agg["precision"] == ref.pope_aggregate_precision(ref_rows)
    assert agg["recall"] == ref.pope_aggregate_recall(ref_rows)
    assert agg["f1"] == ref.pope_aggregate_f1_score(ref_rows)
    assert agg["yes_ratio"] == ref.pope_aggregate_yes_ratio(ref_rows)


def test_textvqa_accuracy_matches_reference():
    vem = _load(f"{REF}/tasks/_task_utils/vqa_eval_metric.py",
                "ref_vem2")
    ref = _load(
        f"{REF}/tasks/textvqa/utils.py", "ref_textvqa",
        extra_stubs=("yaml",),
        extra_modules={
            "lmms_eval.tasks._task_utils.vqa_eval_metric": vem})
    cases = [
        ("Yes.", ["yes"] * 10),
        ("stop", ["stop", "stop sign", "stop", "stop", "sign", "stop",
                  "stop", "stop", "stop", "stop"]),
        ("two dogs", ["2 dogs"] * 10),
        ("coca-cola", ["coca cola", "coke", "coca cola", "coca cola",
                       "cocacola", "coca cola", "coca cola", "coca cola",
                       "coca cola", "pepsi"]),
    ]
    for pred, answers in cases:
        doc = {"question_id": 0, "answers": list(answers)}
        theirs = ref.textvqa_process_results(doc, [pred])["exact_match"]
        ours = M.textvqa_accuracy(pred, answers)
        assert abs(ours - theirs) < 1e-9, (pred, ours, theirs)


def test_ai2d_scienceqa_doc_pipeline_matches_reference():
    filt = types.ModuleType("lmms_eval.filters.extraction")

    class _XRF:
        def __init__(self, *a, **k):
            pass
    filt.ExtendedRegexFilter = _XRF
    trans = types.ModuleType("lmms_eval.filters.transformation")

    class _MF:
        def __init__(self, *a, **k):
            pass
    trans.MapFilter = _MF
    ref_ai2d = _load(
        f"{REF}/tasks/ai2d/utils.py", "ref_ai2d",
        extra_stubs=("lmms_eval.filters",),
        extra_modules={"lmms_eval.filters.extraction": filt,
                       "lmms_eval.filters.transformation": trans})
    ref_sqa = _load(f"{REF}/tasks/scienceqa/utils.py", "ref_sqa")
    from lavida_mod.eval.tasks import get_task

    # ai2d: prompt interpolation + index->letter target
    doc = {"question": "Which part is the root?",
           "options": ["stem", "root", "leaf", "flower"], "answer": "1",
           "id": 0, "text": "Which part is the root?"}
    kwargs = {"pre_prompt": "", "post_prompt": "", "prompt_format": "mcq"}
    ref_text = ref_ai2d.ai2d_doc_to_text(
        {"question": doc["question"], "options": doc["options"]}, kwargs)
    t = get_task("ai2d")
    mapped = t.doc_mapper(dict(doc))
    assert mapped["text"] == ref_text
    assert mapped["target"] == ref_ai2d.ai2d_doc_to_target(
        {"options": doc["options"], "answer": doc["answer"]}, "mcq")
    assert t.score_doc(mapped, "B")["exact_match"] == 1.0
    assert t.score_doc(mapped, "The answer is (B).")["exact_match"] == 1.0

    # scienceqa: hint prefix + the reference's quirky lowered compare
    sdoc = {"question": "What is H2O?", "choices": ["water", "salt"],
            "answer": 0, "hint": "Think simple.", "id": 0,
            "text": "What is H2O?"}
    st = get_task("scienceqa_img")
    smapped = st.doc_mapper(dict(sdoc))
    assert smapped["target"] == ref_sqa.sqa_doc_to_target(
        {"choices": sdoc["choices"], "answer": sdoc["answer"]})
    for pred in ("A", "a", "B", "A. water", "water"):
        theirs = ref_sqa.sqa_process_results(
            {"choices": sdoc["choices"], "answer": sdoc["answer"]},
            [pred])["exact_match"]
        ours = st.score_doc(smapped, pred)["exact_match"]
        assert ours == theirs, (pred, ours, theirs)


def test_realworldqa_scoring_matches_reference():
    filt = types.ModuleType("lmms_eval.filters.extraction")

    class _XRF:
        def __init__(self, *a, **k):
            pass
    filt.ExtendedRegexFilter = _XRF
    trans = types.ModuleType("lmms_eval.filters.transformation")

    class _MF:
        def __init__(self, *a, **k):
            pass
    trans.MapFilter = _MF
    ref = _load(
        f"{REF}/tasks/realworldqa/utils.py", "ref_rwqa",
        extra_stubs=("lmms_eval.filters",),
        extra_modules={"lmms_eval.filters.extraction": filt,
                       "lmms_eval.filters.transformation": trans})
    from lavida_mod.eval.tasks import get_task

    t = get_task("realworldqa")
    for pred, gt in (("A.", "a"), ("two", "two"), ("Two.", "two"),
                     ("2", "two"), ("b", "b"), ("yes!", "yes")):
        theirs = ref.realworldqa_process_results(
            {"answer": gt}, [pred])["exact_match"]
        ours = t.score_doc({"target": gt, "id": 0}, pred)["exact_match"]
        assert ours == theirs, (pred, gt, ours, theirs)


def test_mmmu_prompt_matches_reference_construct_prompt():
    # construct_prompt (mmmu/utils.py:134-143) needs only ast + the
    # parse_options helper; replicate its exact inputs
    import ast as _ast
    ref = _load(f"{REF}/tasks/mmmu/utils.py", "ref_mmmu_prompt",
                extra_stubs=("requests",),
                extra_modules={"openai": _openai_stub(),
                               "yaml": __import__("yaml")})
    from lavida_mod.eval.tasks import get_task

    t = get_task("mmmu_val")
    mc_prompt = "Answer with the option's letter from the given choices directly."
    open_prompt = "Answer the question using a single word or phrase."

    # multiple choice
    rdoc = {"question": "What is shown in <image 1>?",
            "question_type": "multiple-choice",
            "options": "['a cat', 'a dog', 'a fox']"}
    ref_text = ref.construct_prompt(rdoc, mc_prompt, open_prompt)
    doc = t.doc_mapper({"text": rdoc["question"],
                        "choices": _ast.literal_eval(rdoc["options"]),
                        "question_type": "multiple-choice", "id": 0})
    assert t.doc_to_text(doc) == ref_text

    # open-ended
    rdoc2 = {"question": "How many wheels?", "question_type": "open",
             "options": "[]"}
    ref_text2 = ref.construct_prompt(rdoc2, mc_prompt, open_prompt)
    doc2 = t.doc_mapper({"text": rdoc2["question"],
                         "question_type": "open", "id": 1})
    assert t.doc_to_text(doc2) == ref_text2


def _openai_stub():
    import types as _t

    class _Client:
        def __init__(self, *a, **k):
            pass
    m = _t.ModuleType("openai")
    m.AzureOpenAI = _Client
    m.OpenAI = _Client
    return m


def test_mmbench_prompt_matches_reference():
    evals = _load(f"{REF}/tasks/mmbench/mmbench_evals.py", "ref_mmb_ev")

    ev = evals.MMBench_Evaluator()
    from lavida_mod.eval.tasks import get_task

    t = get_task("mmbench_en_dev")
    doc = {"question": "What is shown?", "hint": "A chart about pets.",
           "A": "cats", "B": "dogs", "C": "birds", "D": None,
           "answer": "B", "target": "B", "index": 1, "id": 1,
           "text": "What is shown?"}
    options_prompt, _ = ev.create_options_prompt(
        {k: doc[k] for k in ("A", "B", "C", "D") if doc[k]},
        ["A", "B", "C", "D", "E"])
    ref_text = f"{doc['hint']} {doc['question']} {options_prompt}"
    mapped = t.doc_mapper(dict(doc))
    assert mapped["text"] == ref_text
    assert t.score_doc(mapped, "B")["acc"] == 1.0
    assert t.score_doc(
        mapped, "I believe the picture clearly shows several dogs"
    )["acc"] == 1.0
