"""Round-2 breadth tranche: task registrations, new metrics, filter
wiring, and per-family scoring behavior (reference
eval/lmms_eval/tasks/* semantics; citations in tasks_ext.py)."""

from lavida_mod.eval import filters as F
from lavida_mod.eval import metrics as M
from lavida_mod.eval.tasks import Task, get_task, list_tasks


def test_breadth_tasks_registered():
    expected = [
        # MC image suites
        "mmbench_cn_dev", "mmt_val", "muirbench", "mme_realworld",
        "mme_realworld_lite", "hrbench_4k", "hrbench_8k",
        "illusionvqa_comprehension", "ii_bench", "qbench_dev", "abench_dev",
        "iconqa_val", "mmmu_pro_standard", "mmmu_pro_vision", "cmmmu_val",
        "seedbench_2", "mirb",
        # doc/OCR
        "stvqa", "multidocvqa_val", "websrc_val", "synthdog_en",
        "vcr_wiki_en_easy", "vcr_wiki_en_hard",
        # grounding
        "screenspot_rec_test", "screenspot_reg_test",
        # captions
        "textcaps_val", "detailcaps",
        # hallucination
        "hallusion_bench_image", "naturalbench",
        # math
        "mathvista_testmini", "mathvista_test", "mathverse_testmini",
        "mathvision_test",
        # GPT-judged free-form (offline heuristic + samples log)
        "mmvet", "llava_in_the_wild", "llava_bench_coco",
        "wild_vision_bench", "vibe_eval", "mia_bench",
        # video
        "videomme", "egoschema", "nextqa_mc_test", "mvbench",
        "longvideobench_val_v", "perceptiontest_val_mc",
        "tempcompass_multi_choice", "mlvu", "activitynetqa",
        "videochatgpt_gen", "video_detail_description", "vatex_test",
        "youcook2_val",
        # text-only
        "gsm8k", "mmlu", "mmlu_pro", "arc_easy", "arc_challenge",
        "gpqa_main", "hellaswag",
        # referring expressions
        "refcoco_bbox_rec_val", "refcoco+_bbox_rec_val",
        "refcocog_bbox_rec_val", "refcoco_bbox_val",
    ]
    names = list_tasks()
    missing = [n for n in expected if n not in names]
    assert not missing, missing
    assert len(names) >= 80


def test_squad_f1():
    assert M.squad_f1("the cat sat", ["the cat sat"]) == 1.0
    assert M.squad_f1("cat", ["the cat sat"]) > 0.0
    assert M.squad_f1("dog", ["the cat sat"]) == 0.0
    # articles normalized away (SQuAD normalize_answer)
    assert M.squad_f1("a cat", ["the cat"]) == 1.0


def test_norm_edit_similarity():
    assert M.norm_edit_similarity("abc", "abc") == 1.0
    assert abs(M.norm_edit_similarity("abc", "abd") - 2 / 3) < 1e-9
    assert M.norm_edit_similarity("", "") == 1.0
    assert M.norm_edit_similarity("xyz", "abc") == 0.0


def test_jaccard_word():
    assert M.jaccard_word("a b c", "a b c") == 1.0
    assert abs(M.jaccard_word("covered text", "the covered texts")
               - 1 / 3) < 1e-9


def test_bbox_parsing_and_scoring():
    assert M.parse_bbox("The box is [10, 20, 30, 40].") == (10, 20, 30, 40)
    assert M.parse_bbox("0.1,0.2,0.5,0.6") == (0.1, 0.2, 0.5, 0.6)
    assert M.parse_bbox("no box here") is None
    assert M.bbox_iou((0, 0, 2, 2), (0, 0, 2, 2)) == 1.0
    assert M.bbox_iou((0, 0, 1, 1), (2, 2, 3, 3)) == 0.0
    assert M.center_in_bbox((0, 0, 2, 2), (0.5, 0.5, 3, 3)) == 1.0
    assert M.center_in_bbox(None, (0, 0, 1, 1)) == 0.0

    t = get_task("screenspot_rec_test")
    row = t.score_doc({"bbox": [0, 0, 100, 100], "id": 0},
                      "[10, 10, 90, 90]")
    assert row["acc@0.5"] == 1.0 and row["center_acc"] == 1.0


def test_mathvista_rule_extraction():
    # multi-choice: letter -> option text (normalize_extracted_answer)
    ext = F.extract_final_answer(
        "Reasoning...\nThe answer is B")
    ans = F.normalize_math_answer(
        ext, ["red", "blue", "green"],
        question_type="multi_choice", answer_type="text")
    assert ans == "blue"
    # numeric with precision
    ext = F.extract_final_answer("So the total is 3.14159. Final answer: "
                                 "3.14159")
    assert F.normalize_math_answer(ext, None, answer_type="float",
                                   precision=2) == "3.14"
    # integer
    assert F.normalize_math_answer("42.0", None,
                                   answer_type="integer") == "42"
    # falls back to last number
    assert F.extract_final_answer("first 3 then 7") == "7"

    t = get_task("mathvista_testmini")
    doc = {"target": "blue", "choices": ["red", "blue"], "id": 0,
           "question_type": "multi_choice", "answer_type": "text"}
    assert t.score_doc(doc, "I think the answer is B")["acc"] == 1.0
    assert t.score_doc(doc, "The answer is A")["acc"] == 0.0


def test_gsm8k_filter_chain():
    t = get_task("gsm8k")
    doc = {"target": "reasoning #### 1,234", "id": 0}
    pred = t.apply_filters(
        "Let me think. 617*2 = 1234. The final answer is 1,234", doc)
    assert pred == "1,234"
    assert t.score_doc(doc, pred)["exact_match"] == 1.0
    # fallback token when nothing matches
    assert t.apply_filters("no idea", doc) == "[invalid]"
    assert F.normalize_number("$1,234.") == "1234"


def test_hallusion_aggregation():
    t = get_task("hallusion_bench_image")

    def row(set_id, fig, q, correct):
        return {"correct": correct, "category": "VD", "subcategory": "x",
                "set_id": set_id, "figure_id": fig, "question_id": q}

    rows = [row("0", "0", "0", 1.0), row("0", "1", "0", 1.0),
            row("0", "0", "1", 1.0), row("0", "1", "1", 0.0)]
    agg = t.aggregate(rows)
    assert agg["aAcc"] == 0.75
    # qAcc: question 0 pair right (figs 0+1), question 1 pair wrong
    assert agg["qAcc"] == 0.5
    # fAcc: figure 0 all right, figure 1 has a miss
    assert agg["fAcc"] == 0.5
    # scoring path: yes/no grade
    r = t.score_doc({"target": "yes", "category": "VD", "subcategory": "s",
                     "set_id": 1, "figure_id": 2, "question_id": 3,
                     "id": 0}, "Yes, it is.")
    assert r["correct"] == 1.0 and r["set_id"] == "1"


def test_naturalbench_grouped_metrics():
    t = get_task("naturalbench")
    rows = [{"correct": 1.0}, {"correct": 1.0},
            {"correct": 1.0}, {"correct": 0.0}]
    agg = t.aggregate(rows)
    assert agg["ACC"] == 0.75
    assert agg["Q_ACC"] == 0.5   # q0 both imgs right, q1 not
    assert agg["I_ACC"] == 0.5   # i0 both qs right, i1 not
    assert agg["G_ACC"] == 0.0


def test_seedbench2_mapping_and_grouping():
    t = get_task("seedbench_2")
    doc = {"text": "What is shown?", "choice_a": "cat", "choice_b": "dog",
           "choice_c": "bird", "choice_d": "fish", "answer": "B",
           "data_type": "Single Image", "id": 0}
    doc = t.doc_mapper(doc)
    assert "A. cat" in doc["text"] and "D. fish" in doc["text"]
    row = t.score_doc(doc, "B. dog")
    assert row["acc"] == 1.0 and row["data_type"] == "Single_Image"
    agg = t.aggregate([row, {**row, "acc": 0.0, "data_type": "Video"}])
    assert agg["seed_Single_Image"] == 1.0 and agg["seed_Video"] == 0.0
    assert agg["seed_all"] == 0.5


def test_mc_letter_score_with_option_text_gold():
    t = get_task("mirb")
    assert t.score_doc({"target": "42", "id": 0}, "42")["acc"] == 1.0
    t2 = get_task("mmt_val")
    doc = {"target": "C", "choices": ["one", "two", "three"], "id": 0,
           "text": "q"}
    assert t2.score_doc(doc, "C")["acc"] == 1.0
    # >5 words triggers the option-content containment branch
    # (mmmu/utils.py parse_multi_choice_response)
    assert t2.score_doc(
        doc, "I believe the correct answer should be three")["acc"] == 1.0


def test_videomme_prompt_construction():
    t = get_task("videomme")
    doc = {"text": "What happens?", "options": ["A. runs", "B. sits"],
           "target": "A", "id": 0}
    doc = t.doc_mapper(doc)
    assert "Select the best answer" in doc["text"]
    assert doc["text"].rstrip().endswith("The best answer is:")
    assert t.score_doc(doc, "A")["acc"] == 1.0


def test_synthdog_gt_parse():
    t = get_task("synthdog_en")
    doc = t.doc_mapper({"ground_truth":
                        '{"gt_parse": {"text_sequence": "hello world"}}',
                        "id": 0})
    assert doc["target"] == "hello world"
    assert t.score_doc(doc, "hello world")["ned_acc"] == 1.0


def test_vcr_and_websrc_scoring():
    t = get_task("vcr_wiki_en_easy")
    # reference protocol (vcr_wiki/utils.py): a prediction SHORTER than
    # the covered span has no length-n ngram -> 0, exactly as upstream
    r = t.score_doc({"target": "the hidden text", "id": 0}, "hidden text")
    assert r["jaccard"] == 0.0
    r = t.score_doc({"target": "the hidden text", "id": 0},
                    "it says the hidden text")
    assert r["jaccard"] == 1.0 and r["exact_match"] == 1.0
    w = get_task("websrc_val")
    assert w.score_doc({"target": "42 dollars", "id": 0},
                       "42 dollars")["websrc_squad_f1"] == 1.0


def test_hellaswag_loglikelihood_protocol():
    t = get_task("hellaswag")
    assert t.output_type == "loglikelihood"
    doc = t.doc_mapper({"ctx": "He picks up the guitar",
                        "endings": ["and plays", "and eats it"],
                        "label": "0", "id": 0})
    assert doc["target"] == "and plays"
    assert t.score_doc(doc, "and plays")["acc"] == 1.0


def test_filter_ensemble_wired_through_evaluate():
    """The evaluator applies task.filter_ensemble before scoring."""
    from lavida_mod.eval.evaluator import evaluate

    class FakeModel:
        avg_latency = 0.0

        def generate_until(self, text, images, kwargs):
            return "blah blah The final answer is 7"

    t = get_task("gsm8k")
    out = evaluate(FakeModel(), t,
                   [{"text": "3+4?", "target": "#### 7", "images": [],
                     "id": 0}],
                   progress=False)
    assert out["results"]["exact_match"] == 1.0


def test_mmerealworld_post_prompt():
    t = get_task("mme_realworld")
    assert "(A, B, C, D, or E)" in t.post_prompt
    doc = {"text": "q", "choices": ["x", "y", "z", "w", "v"],
           "target": "E", "id": 0}
    assert t.score_doc(doc, "E")["acc"] == 1.0


def test_refcoco_rec_pipeline():
    from PIL import Image

    t = get_task("refcoco_bbox_rec_val")
    img = Image.new("RGB", (200, 100))
    doc = t.doc_mapper({"bbox": [20, 10, 60, 40], "images": [img],
                        "answer": ["the red car"], "id": 0})
    # pixel (x,y,w,h) -> normalized corners (utils_rec.py:12-22)
    assert doc["bbox"] == [0.1, 0.1, 0.4, 0.5]
    assert doc["text"].endswith("describes: the red car")
    row = t.score_doc(doc, "[0.1, 0.1, 0.4, 0.5]")
    assert row["ACC@0.9"] == 1.0 and row["Center_ACC"] == 1.0
    row = t.score_doc(doc, "no box")
    assert row["IoU"] == 0.0 and row["ACC@0.1"] == 0.0
    agg = t.aggregate([t.score_doc(doc, "[0.1, 0.1, 0.4, 0.5]"),
                       t.score_doc(doc, "no box")])
    assert agg["IoU"] == 0.5 and agg["ACC@0.5"] == 0.5


def test_ifeval_verifiers():
    from lavida_mod.eval import ifeval as IF

    assert IF.check_instruction("punctuation:no_comma", "no commas here",
                                {})
    assert not IF.check_instruction("punctuation:no_comma", "a, b", {})
    assert IF.check_instruction("detectable_format:title",
                                "<<My Great Title>>\nbody", {})
    assert IF.check_instruction(
        "keywords:existence", "the cat and the dog",
        {"keywords": ["cat", "dog"]})
    assert not IF.check_instruction(
        "keywords:forbidden_words", "the cat", {"forbidden_words": ["cat"]})
    assert IF.check_instruction(
        "length_constraints:number_words", "one two three",
        {"num_words": 3, "relation": "at least"})
    assert IF.check_instruction(
        "length_constraints:number_paragraphs", "a\n***\nb\n***\nc",
        {"num_paragraphs": 3})
    assert IF.check_instruction("detectable_format:json_format",
                                '```json\n{"a": 1}\n```', {})
    assert IF.check_instruction("change_case:english_lowercase",
                                "all lower case.", {})
    assert IF.check_instruction("startend:quotation", '"quoted"', {})
    assert IF.check_instruction(
        "combination:two_responses", "yes\n******\nno", {})
    assert IF.check_instruction(
        "detectable_content:postscript",
        "body\nP.S. remember this", {"postscript_marker": "P.S."})
    assert IF.check_instruction(
        "length_constraints:nth_paragraph_first_word",
        "First para here\n\nSecond para here",
        {"num_paragraphs": 2, "nth_paragraph": 2, "first_word": "second"})


def test_ifeval_strict_vs_loose():
    from lavida_mod.eval import ifeval as IF

    doc = {"instruction_id_list": ["change_case:english_lowercase"],
           "kwargs": [{}]}
    # a wrapper first line breaks strict; loose drops it and passes
    resp = "Sure! Here it is:\nall lower from here on."
    row = IF.score_ifeval(doc, resp)
    assert row["prompt_level_strict_acc"] == 0.0
    assert row["prompt_level_loose_acc"] == 1.0
    agg = IF.aggregate_ifeval([row, row])
    assert agg["inst_level_loose_acc"] == 1.0

    t = get_task("ifeval")
    doc2 = t.doc_mapper({"prompt": "Write in lowercase.",
                         "instruction_id_list":
                             ["change_case:english_lowercase"],
                         "kwargs": [{}], "id": 0})
    assert doc2["text"] == "Write in lowercase."
    assert t.score_doc(doc2, "fine.")["prompt_level_strict_acc"] == 1.0


def test_final_tranche_registered():
    for name in ("cinepile", "egoplan", "gqa_ru", "dtcbench", "vinoground",
                 "vitatecs", "temporalbench", "mix_evals_video2text_mc",
                 "moviechat_global", "vdc", "llava_wilder_small",
                 "multilingual_llava_bench", "ferret", "openhermes",
                 "vl_rewardbench", "olympiadbench",
                 "llava_interleave_bench_in_domain", "charades_sta"):
        assert name in list_tasks(), name
    assert len(list_tasks()) >= 110


def test_charades_temporal_iou():
    t = get_task("charades_sta")
    r = t.score_doc({"timestamp": [2.0, 8.0], "id": 0},
                    "The action happens from 4 to 8 seconds.")
    assert abs(r["tIoU"] - 4 / 6) < 1e-9 and r["R@0.5"] == 1.0
    assert t.score_doc({"timestamp": [2.0, 8.0], "id": 0},
                       "around 20 to 30")["tIoU"] == 0.0
    agg = t.aggregate([r, {"tIoU": 0.0, "R@0.5": 0.0}])
    assert abs(agg["tIoU"] - 1 / 3) < 1e-9 and agg["R@0.5"] == 0.5


# ---------------------------------------------------------------------------
# round-3 long tail
# ---------------------------------------------------------------------------

def test_round3_families_registered():
    import lavida_mod.eval.tasks_ext as TE
    from lavida_mod.eval.tasks import _TASKS

    for name in ("vcr_wiki_en_easy", "vcr_wiki_zh_hard", "conbench",
                 "jmmmu", "livexiv_tqa", "livexiv_vqa", "av_odyssey",
                 "cuva", "funqa", "megabench", "llava_in_the_wild_arabic",
                 "llava_in_the_wild_urdu", "egothink", "cvrr"):
        assert name in _TASKS, name
    assert len(_TASKS) >= 131
    # the N/A manifest covers the audio + live families explicitly
    for name in ("librispeech", "air_bench", "live_bench", "mmsearch"):
        assert name in TE.NOT_APPLICABLE_TASKS


def test_vcr_scoring():
    from lavida_mod.eval.tasks import _TASKS

    t = _TASKS["vcr_wiki_en_easy"]
    doc = {"crossed_text": ["hello world"], "target": "hello world"}
    # exact restore inside a longer answer
    row = t.score_doc(doc, "the covered text is hello world indeed")
    assert row["exact_match"] == 1.0 and row["jaccard"] == 1.0
    # refusal short-circuits to zero (fast_filter, utils.py:56-68)
    row = t.score_doc(doc, "I cannot see the covered text, sorry")
    assert row["exact_match"] == 0.0 and row["jaccard"] == 0.0
    # partial overlap
    row = t.score_doc(doc, "maybe hello there")
    assert 0.0 < row["jaccard"] < 1.0


def test_conbench_consistency_aggregate():
    from lavida_mod.eval.tasks import _TASKS

    t = _TASKS["conbench"]
    rows = []
    # image 1: all three question fields right -> consistent
    rows.append(t.score_doc({"question_field": "N/Y", "answer": "yes",
                             "image_id": 1}, "Yes, it is."))
    rows.append(t.score_doc({"question_field": "Choices", "answer": "b",
                             "image_id": 1}, " B"))
    rows.append(t.score_doc({"question_field": "Q/A", "answer": "a cat",
                             "image_id": 1}, "a cat"))
    # image 2: one wrong -> not consistent
    rows.append(t.score_doc({"question_field": "N/Y", "answer": "no",
                             "image_id": 2}, "yes"))
    rows.append(t.score_doc({"question_field": "Choices", "answer": "a",
                             "image_id": 2}, "A"))
    rows.append(t.score_doc({"question_field": "Q/A", "answer": "dog",
                             "image_id": 2}, "dog"))
    agg = t.aggregate(rows)
    assert agg["ConScore_D"] == 0.5


def test_livexiv_parse():
    from lavida_mod.eval.tasks import _TASKS

    t = _TASKS["livexiv_tqa"]
    assert t.score_doc({"gt": "B"}, "B")["acc"] == 1.0
    assert t.score_doc({"gt": "B"}, "The answer is B")["acc"] == 1.0
    assert t.score_doc({"gt": "B"}, "Certainly!")["acc"] == 0.0
    d = t.doc_mapper({"question": "Q?", "option_a": "w", "option_b": "x",
                      "option_c": "y", "option_d": "z"})
    assert "A. w" in d["text"] and "letter" in d["text"]


def test_av_odyssey_parse_and_agg():
    from lavida_mod.eval.tasks import _TASKS

    t = _TASKS["av_odyssey"]
    doc = {"options": ["A. red", "B. blue", "C. green", "D. gray"],
           "answer": "B", "subfield": "timbre"}
    r1 = t.score_doc(doc, "The answer is B.")
    assert r1["acc"] == 1.0 and r1["category"] == "timbre"
    r2 = t.score_doc(doc, "It looks blue to me and not like any other hue")
    assert r2["acc"] == 1.0  # content containment
    agg = t.aggregate([r1, {"acc": 0.0, "category": "other"}])
    assert 0.0 < agg["acc"] < 1.0


def test_jmmmu_prompt_construction():
    from lavida_mod.eval.tasks import _TASKS

    t = _TASKS["jmmmu"]
    d = t.doc_mapper({"question": "<image1> これは何ですか？",
                      "question_type": "multiple-choice",
                      "options": "['犬', '猫']", "answer": "B"})
    assert "<image 1>" in d["text"]
    assert "A. 犬" in d["text"] and "アルファベット" in d["text"]
    assert t.score_doc(d, "B")["acc"] == 1.0
    d2 = t.doc_mapper({"question": "説明してください",
                       "question_type": "open", "answer": "東京"})
    assert "短いフレーズ" in d2["text"]
