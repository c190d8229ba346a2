"""The port's copy of ``llama_kotlin_tpu/runtime/chat.py``: chat template application.

Parity target: llama_chat_apply_template_internal (reference
src/llama.cpp:19732-19995), which pattern-matches the model's stored jinja
template string and applies a hardcoded equivalent — same approach here
(no jinja dependency), with the SAME branch set, detection substrings and
if/else ordering, so every template the reference formats, we format
byte-identically (tests/test_tools.py cross-checks against the cases in
reference tests/test-chat-template.cpp).

Unknown templates raise ValueError (the reference returns -1, letting the
caller fall back deliberately); the chatml fallback lives in the CLI /
server layers only.
"""

from __future__ import annotations

from typing import Iterable


def _trim(s: str) -> str:
    return s.strip()


KNOWN_TEMPLATES = (
    "chatml", "llama2", "mistral", "phi3", "zephyr", "monarch", "gemma",
    "gemma2", "orion", "openchat", "vicuna", "vicuna-orca", "deepseek",
    "command-r", "llama3", "chatglm3", "chatglm4", "minicpm", "deepseek2",
    "exaone3", "openassistant",
)


def detect_template(template_str: str | None, arch: str = "") -> str:
    """Canonical template name for a model's stored jinja template string.

    Mirrors the contains-chain (and its ORDER) of
    llama_chat_apply_template_internal; raises ValueError when the
    template is unrecognized — callers that want the reference CLI's
    chatml default must fall back explicitly."""
    t = template_str or ""
    if t in KNOWN_TEMPLATES:
        return t
    if "<|im_start|>" in t:
        return "chatml"
    if "[INST]" in t:
        return "mistral" if "<<SYS>>" not in t else "llama2"
    if "<|assistant|>" in t and "<|end|>" in t:
        return "phi3"
    if "<|prompter|>" in t:
        return "openassistant"
    if "<|user|>" in t:
        return "zephyr"
    if "bos_token + message['role']" in t:
        return "monarch"
    if "<start_of_turn>" in t:
        return "gemma"
    if "'\\n\\nAssistant: ' + eos_token" in t:
        return "orion"
    if "GPT4 Correct " in t:
        return "openchat"
    if "USER: " in t and "ASSISTANT: " in t:
        return "vicuna-orca" if "SYSTEM: " in t else "vicuna"
    if "### Instruction:" in t and "<|EOT|>" in t:
        return "deepseek"
    if "<|START_OF_TURN_TOKEN|>" in t and "<|USER_TOKEN|>" in t:
        return "command-r"
    if "<|start_header_id|>" in t and "<|end_header_id|>" in t:
        return "llama3"
    if "[gMASK]sop" in t:
        return "chatglm3"
    if "[gMASK]<sop>" in t:
        return "chatglm4"
    if "<用户>" in t:
        return "minicpm"
    if "'Assistant: ' + message['content'] + eos_token" in t:
        return "deepseek2"
    if "[|system|]" in t and "[|assistant|]" in t and "[|endofturn|]" in t:
        return "exaone3"
    if arch.startswith("gemma"):
        return "gemma"
    raise ValueError(f"unrecognized chat template: {t[:80]!r}")


def resolve_template(template_str: str | None, arch: str = "") -> str:
    """CLI/server-layer resolution: keep the model's RAW template string
    when it is recognized (so llama2-family variant bits like
    space-around-response format exactly), fall back to chatml with a
    warning otherwise — mirroring the reference server's startup template
    verification (examples/server/server.cpp validate + chatml default).
    The API itself (apply_chat_template / detect_template) errors on
    unknown templates instead."""
    import logging

    t = template_str or ""
    if not t and arch.startswith("gemma"):
        return "gemma"
    try:
        detect_template(t, arch)
        return t if t else "chatml"
    except ValueError:
        logging.getLogger(__name__).warning(
            "unrecognized chat template (%r...); falling back to chatml",
            t[:60])
        return "chatml"


def apply_chat_template(messages: Iterable[dict], template: str = "chatml",
                        add_assistant: bool = True) -> str:
    """Format `messages` ([{role, content}, ...]) with `template` — either
    a canonical name (KNOWN_TEMPLATES) or the model's raw jinja template
    string (matched by the same substrings the reference uses)."""
    msgs = list(messages)
    tmpl = template or ""
    has = lambda s: s in tmpl  # noqa: E731 (mirrors tmpl_contains)
    out: list[str] = []

    if tmpl == "chatml" or has("<|im_start|>"):
        for m in msgs:
            out.append(f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n")
        if add_assistant:
            out.append("<|im_start|>assistant\n")
        return "".join(out)

    if tmpl in ("llama2", "mistral") or has("[INST]"):
        # llama2 template and its variants (reference :19750-19784)
        support_system = has("<<SYS>>") or tmpl == "mistral"
        space_around_response = has("' ' + eos_token")
        add_bos_inside_history = has("bos_token + '[INST]")
        strip_message = has("content.strip()")
        is_inside_turn = True  # skip BOS at the beginning
        out.append("[INST] ")
        for m in msgs:
            content = _trim(m["content"]) if strip_message else m["content"]
            role = m["role"]
            if not is_inside_turn:
                is_inside_turn = True
                out.append("<s>[INST] " if add_bos_inside_history else "[INST] ")
            if role == "system":
                if support_system:
                    out.append(f"<<SYS>>\n{content}\n<</SYS>>\n\n")
                else:
                    # unsupported system message still rides the first turn
                    out.append(content + "\n")
            elif role == "user":
                out.append(content + " [/INST]")
            else:
                sp = " " if space_around_response else ""
                out.append(f"{sp}{content}{sp}</s>")
                is_inside_turn = False
        # llama2 templates ignore add_assistant (reference comment)
        return "".join(out)

    if tmpl == "phi3" or (has("<|assistant|>") and has("<|end|>")):
        for m in msgs:
            out.append(f"<|{m['role']}|>\n{m['content']}<|end|>\n")
        if add_assistant:
            out.append("<|assistant|>\n")
        return "".join(out)

    if tmpl == "openassistant" or has("<|prompter|>"):
        # openassistant (oasst) — not in the reference's chain; kept for
        # the CLI's --chat-template openassistant
        for m in msgs:
            role = "prompter" if m["role"] == "user" else m["role"]
            out.append(f"<|{role}|>{m['content']}<|endoftext|>")
        if add_assistant:
            out.append("<|assistant|>")
        return "".join(out)

    if tmpl == "zephyr" or has("<|user|>"):
        for m in msgs:
            out.append(f"<|{m['role']}|>\n{m['content']}<|endoftext|>\n")
        if add_assistant:
            out.append("<|assistant|>\n")
        return "".join(out)

    if tmpl == "monarch" or has("bos_token + message['role']"):
        # mlabonne/AlphaMonarch-7B (<s> inside history, skipped on first)
        for i, m in enumerate(msgs):
            bos = "" if i == 0 else "<s>"
            out.append(f"{bos}{m['role']}\n{m['content']}</s>\n")
        if add_assistant:
            out.append("<s>assistant\n")
        return "".join(out)

    if tmpl in ("gemma", "gemma2") or has("<start_of_turn>"):
        system_prompt = ""
        for m in msgs:
            role = m["role"]
            if role == "system":
                # no system role in gemma: merged into the next user turn
                system_prompt = _trim(m["content"])
                continue
            role = "model" if role == "assistant" else role
            out.append(f"<start_of_turn>{role}\n")
            if system_prompt and role != "model":
                out.append(system_prompt + "\n\n")
                system_prompt = ""
            out.append(_trim(m["content"]) + "<end_of_turn>\n")
        if add_assistant:
            out.append("<start_of_turn>model\n")
        return "".join(out)

    if tmpl == "orion" or has("'\\n\\nAssistant: ' + eos_token"):
        # OrionStarAI/Orion-14B-Chat
        system_prompt = ""
        for m in msgs:
            role = m["role"]
            if role == "system":
                system_prompt = m["content"]
            elif role == "user":
                out.append("Human: ")
                if system_prompt:
                    out.append(system_prompt + "\n\n")
                    system_prompt = ""
                out.append(m["content"] + "\n\nAssistant: </s>")
            else:
                out.append(m["content"] + "</s>")
        return "".join(out)

    if tmpl == "openchat" or has("GPT4 Correct "):
        for m in msgs:
            role = m["role"]
            if role == "system":
                out.append(m["content"] + "<|end_of_turn|>")
            else:
                out.append(f"GPT4 Correct {role[:1].upper()}{role[1:]}: "
                           f"{m['content']}<|end_of_turn|>")
        if add_assistant:
            out.append("GPT4 Correct Assistant:")
        return "".join(out)

    if tmpl in ("vicuna", "vicuna-orca") or (has("USER: ") and has("ASSISTANT: ")):
        for m in msgs:
            role = m["role"]
            if role == "system":
                if tmpl == "vicuna-orca" or has("SYSTEM: "):
                    out.append(f"SYSTEM: {m['content']}\n")
                else:
                    out.append(m["content"] + "\n\n")
            elif role == "user":
                out.append(f"USER: {m['content']}\n")
            elif role == "assistant":
                out.append(f"ASSISTANT: {m['content']}</s>\n")
        if add_assistant:
            out.append("ASSISTANT:")
        return "".join(out)

    if tmpl == "deepseek" or (has("### Instruction:") and has("<|EOT|>")):
        # deepseek-ai/deepseek-coder-33b-instruct
        for m in msgs:
            role = m["role"]
            if role == "system":
                out.append(m["content"])
            elif role == "user":
                out.append(f"### Instruction:\n{m['content']}\n")
            elif role == "assistant":
                out.append(f"### Response:\n{m['content']}\n<|EOT|>\n")
        if add_assistant:
            out.append("### Response:\n")
        return "".join(out)

    if tmpl == "command-r" or (has("<|START_OF_TURN_TOKEN|>") and has("<|USER_TOKEN|>")):
        token = {"system": "<|SYSTEM_TOKEN|>", "user": "<|USER_TOKEN|>",
                 "assistant": "<|CHATBOT_TOKEN|>"}
        for m in msgs:
            out.append("<|START_OF_TURN_TOKEN|>" + token[m["role"]]
                       + _trim(m["content"]) + "<|END_OF_TURN_TOKEN|>")
        if add_assistant:
            out.append("<|START_OF_TURN_TOKEN|><|CHATBOT_TOKEN|>")
        return "".join(out)

    if tmpl == "llama3" or (has("<|start_header_id|>") and has("<|end_header_id|>")):
        for m in msgs:
            out.append(f"<|start_header_id|>{m['role']}<|end_header_id|>\n\n"
                       f"{_trim(m['content'])}<|eot_id|>")
        if add_assistant:
            out.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
        return "".join(out)

    if tmpl == "chatglm3" or has("[gMASK]sop"):
        out.append("[gMASK]sop")
        for m in msgs:
            out.append(f"<|{m['role']}|>\n {m['content']}")
        if add_assistant:
            out.append("<|assistant|>")
        return "".join(out)

    if tmpl == "chatglm4" or has("[gMASK]<sop>"):
        out.append("[gMASK]<sop>")
        for m in msgs:
            out.append(f"<|{m['role']}|>\n{m['content']}")
        if add_assistant:
            out.append("<|assistant|>")
        return "".join(out)

    if tmpl == "minicpm" or has("<用户>"):
        # MiniCPM-3B-OpenHermes-2.5-v2
        for m in msgs:
            if m["role"] == "user":
                out.append("<用户>" + _trim(m["content"]) + "<AI>")
            else:
                out.append(_trim(m["content"]))
        return "".join(out)

    if tmpl == "deepseek2" or has("'Assistant: ' + message['content'] + eos_token"):
        # DeepSeek-V2
        for m in msgs:
            role = m["role"]
            if role == "system":
                out.append(m["content"] + "\n\n")
            elif role == "user":
                out.append(f"User: {m['content']}\n\n")
            elif role == "assistant":
                out.append(f"Assistant: {m['content']}<｜end▁of▁sentence｜>")
        if add_assistant:
            out.append("Assistant:")
        return "".join(out)

    if tmpl == "exaone3" or (has("[|system|]") and has("[|assistant|]")
                             and has("[|endofturn|]")):
        for m in msgs:
            role = m["role"]
            if role == "system":
                out.append(f"[|system|]{_trim(m['content'])}[|endofturn|]\n")
            elif role == "user":
                out.append(f"[|user|]{_trim(m['content'])}\n")
            elif role == "assistant":
                out.append(f"[|assistant|]{_trim(m['content'])}[|endofturn|]\n")
        if add_assistant:
            out.append("[|assistant|]")
        return "".join(out)

    raise ValueError(f"unknown chat template {template!r}")
