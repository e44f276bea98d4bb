"""Image OCR / caption enrichment, an offline stage (port of
``easyrag_tpu/corpus/ocr.py``).

Re-implements ``src/get_ocr_data.py``: for every figure harvested by the
zedx preprocessor, run OCR and keep only images whose OCR text contains
Chinese; caption the kept images with a vision LLM; write
``imgmap_filtered.json``.

The OCR engine and captioner are injectable callables: PaddleOCR and
GLM-4V are not dependencies (and this stage runs on the host, off the
serving path), so the default constructors raise ``ImportError`` naming
their packages when those are absent, while the flow itself stays testable
with fakes.
"""

from __future__ import annotations

import json
import os
import re
from typing import Callable, Dict, Optional


def contains_chinese(s: str) -> bool:
    return re.search(r"[一-鿿]", s) is not None


def paddle_ocr_fn() -> Callable[[str], str]:  # pragma: no cover - needs paddle
    try:
        from paddleocr import PaddleOCR
    except ImportError as e:
        raise ImportError(
            "paddleocr is not available in this environment; pass a custom "
            "ocr_fn to filter_imgmap (the OCR stage is offline/CPU-side)"
        ) from e
    ocr = PaddleOCR(use_angle_cls=True, lang="ch")

    def run(img_path: str) -> str:
        result = ocr.ocr(img_path, cls=True)
        content = ""
        for res in result or []:
            try:
                for line in res:
                    content += line[1][0] + "\n"
            except Exception:
                continue
        return content

    return run


def glm4v_caption_fn(model_name: str = "THUDM/glm-4v-9b") -> Callable[[str], str]:
    """Local GLM-4V captioner (``src/easyrag/utils/mllm_utils.py``):
    transparent PNGs composited onto white, then captioned."""
    import torch

    try:
        from PIL import Image
        from transformers import AutoModelForCausalLM, AutoTokenizer
    except ImportError as e:
        raise ImportError(
            "the GLM-4V captioner needs PIL and transformers; pass a custom "
            "caption_fn to filter_imgmap (the caption stage is offline/CPU-side)"
        ) from e

    tokenizer = AutoTokenizer.from_pretrained(model_name, trust_remote_code=True)
    model = AutoModelForCausalLM.from_pretrained(
        model_name, torch_dtype=torch.bfloat16, low_cpu_mem_usage=True,
        trust_remote_code=True,
    ).eval()

    def run(img_path: str) -> str:
        image = Image.open(img_path)
        if image.mode == "RGBA":
            white = Image.new("RGB", image.size, (255, 255, 255))
            white.paste(image, mask=image.split()[3])
            image = white
        else:
            image = image.convert("RGB")
        query = "请详细描述这张图片的内容"
        inputs = tokenizer.apply_chat_template(
            [{"role": "user", "image": image, "content": query}],
            add_generation_prompt=True, tokenize=True, return_tensors="pt",
            return_dict=True,
        )
        with torch.no_grad():
            out = model.generate(**inputs, max_new_tokens=512, do_sample=False)
        return tokenizer.decode(
            out[0][inputs["input_ids"].shape[1]:], skip_special_tokens=True
        )

    return run


def filter_imgmap(
    imgmap_raw_path: str,
    image_root: str,
    out_path: Optional[str] = None,
    ocr_fn: Optional[Callable[[str], str]] = None,
    caption_fn: Optional[Callable[[str], str]] = None,
) -> Dict:
    """imgmap_raw.json -> imgmap_filtered.json.

    Keep images whose existing content or OCR text contains Chinese
    (``get_ocr_data.py:86-92``); caption kept images; captioning failures
    keep the entry without ``content`` (:99-102 swallow + continue).
    """
    ocr_fn = ocr_fn or paddle_ocr_fn()
    caption_fn = caption_fn or glm4v_caption_fn()
    with open(imgmap_raw_path, encoding="utf-8") as f:
        img_map = json.load(f)
    new_map: Dict = {}
    for file_path, figures in img_map.items():
        for img_name, obj in figures.items():
            img_abs = os.path.join(image_root, obj["img_path"])
            if "content" in obj:
                keep = True
            else:
                ocr_text = ocr_fn(img_abs)
                keep = ocr_text != "" and contains_chinese(ocr_text)
            if not keep:
                continue
            new_map.setdefault(file_path, {})[img_name] = dict(obj)
            try:
                new_map[file_path][img_name]["content"] = caption_fn(img_abs)
            except Exception:
                continue
    if out_path:
        with open(out_path, "w", encoding="utf-8") as f:
            json.dump(new_map, f, ensure_ascii=False, indent=4)
    return new_map


if __name__ == "__main__":  # pragma: no cover
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--imgmap", default="../data/format_data_with_img/imgmap_raw.json")
    parser.add_argument("--image-root", default="../data/format_data_with_img")
    parser.add_argument(
        "--out", default="../data/format_data_with_img/imgmap_filtered.json"
    )
    args = parser.parse_args()
    filter_imgmap(args.imgmap, args.image_root, args.out)
