"""Japanese lexicon for the lattice tokenizer: seed entries + a
conjugation generator.

Ref: deeplearning4j-nlp-japanese bundles full IPADIC (~12MB binary,
~390k surface forms) inside its Kuromoji fork. This image has no network
egress, so instead of shipping a large binary this module *generates* the
inflected surface forms IPADIC lists explicitly: each seed verb carries
its conjugation class (godan row / ichidan / irregular) and an engine
expands it to the standard paradigm (dictionary, 連用形, て/た with 音便,
negative, potential, passive, volitional, conditional, imperative), and
each い-adjective expands to its five common forms. ~200 seed verbs and
~80 adjectives plus nouns/loanwords/particles yield several thousand
surface entries — the coverage that decides segmentation quality for
everyday text, at a few KB of source.

Entry format matches lattice_tokenizer: surface -> [(pos, cost, base)].
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

Entries = Dict[str, List[Tuple[str, int, Optional[str]]]]

# godan ending -> (irrealis 未然, continuative 連用, euphonic て-stem,
#                 potential 仮定/可能 stem, volitional stem)
_GODAN = {
    "う": ("わ", "い", "っ", "え", "お"),
    "く": ("か", "き", "い", "け", "こ"),
    "ぐ": ("が", "ぎ", "い", "げ", "ご"),
    "す": ("さ", "し", "し", "せ", "そ"),
    "つ": ("た", "ち", "っ", "て", "と"),
    "ぬ": ("な", "に", "ん", "ね", "の"),
    "ぶ": ("ば", "び", "ん", "べ", "ぼ"),
    "む": ("ま", "み", "ん", "め", "も"),
    "る": ("ら", "り", "っ", "れ", "ろ"),
}
_VOICED_TE = {"ぐ": True, "ぬ": True, "ぶ": True, "む": True}


def conjugate_verb(dict_form: str, klass: str) -> List[Tuple[str, str]]:
    """All (surface, kind) paradigm forms for a verb, kind in
    {'dict','cont','te','ta','neg','pot','pass','vol','cond','imp'}."""
    out = [(dict_form, "dict")]
    if klass == "ichidan":
        stem = dict_form[:-1]
        out += [(stem, "cont"), (stem + "て", "te"), (stem + "た", "ta"),
                (stem + "ない", "neg"), (stem + "なかった", "neg"),
                (stem + "られる", "pass"), (stem + "よう", "vol"),
                (stem + "れば", "cond"), (stem + "ろ", "imp")]
        return out
    if klass == "suru":  # する-compound: caller passes the する part
        base = dict_form[:-2]
        out += [(base + "し", "cont"), (base + "して", "te"),
                (base + "した", "ta"), (base + "しない", "neg"),
                (base + "できる", "pot"), (base + "される", "pass"),
                (base + "されて", "pass"), (base + "された", "pass"),
                (base + "します", "pol"), (base + "しました", "pol"),
                (base + "しよう", "vol"), (base + "すれば", "cond"),
                (base + "しろ", "imp")]
        return out
    if klass == "kuru":
        base = dict_form[:-2]
        out += [(base + "来", "cont"), (base + "来て", "te"),
                (base + "来た", "ta"), (base + "来ない", "neg"),
                (base + "来られる", "pass"), (base + "来よう", "vol"),
                (base + "来れば", "cond"), (base + "来い", "imp")]
        return out
    end = dict_form[-1]
    stem = dict_form[:-1]
    irr, cont, te, pot, vol = _GODAN[end]
    te_suf = ("で" if _VOICED_TE.get(end) else "て")
    ta_suf = ("だ" if _VOICED_TE.get(end) else "た")
    if dict_form == "行く":  # the classic 音便 exception: 行って
        te_stem = "行っ"
    else:
        te_stem = stem + te
    out += [(stem + cont, "cont"),
            (te_stem + te_suf, "te"), (te_stem + ta_suf, "ta"),
            (stem + irr + "ない", "neg"), (stem + irr + "なかった", "neg"),
            (stem + pot + "る", "pot"), (stem + irr + "れる", "pass"),
            (stem + vol + "う", "vol"), (stem + pot + "ば", "cond"),
            (stem + pot, "imp")]
    return out


def conjugate_i_adjective(dict_form: str) -> List[Tuple[str, str]]:
    stem = dict_form[:-1]
    return [(dict_form, "dict"), (stem + "く", "adv"),
            (stem + "かった", "past"), (stem + "くない", "neg"),
            (stem + "くなかった", "neg"), (stem + "ければ", "cond"),
            (stem + "さ", "nominal")]


# --------------------------------------------------------------------------
# seed data
# --------------------------------------------------------------------------

# (dictionary form, class); classes: godan (by final kana), ichidan,
# suru (〜する compounds incl. bare する), kuru
VERBS: List[Tuple[str, str]] = [
    ("住む", "godan"), ("行く", "godan"), ("見る", "ichidan"),
    ("食べる", "ichidan"), ("飲む", "godan"), ("する", "suru"),
    ("やる", "godan"), ("いる", "ichidan"), ("ある", "godan"),
    ("なる", "godan"), ("思う", "godan"), ("言う", "godan"),
    ("読む", "godan"), ("書く", "godan"), ("聞く", "godan"),
    ("話す", "godan"), ("買う", "godan"), ("使う", "godan"),
    ("作る", "godan"), ("歩く", "godan"), ("走る", "godan"),
    ("帰る", "godan"), ("働く", "godan"), ("待つ", "godan"),
    ("分かる", "godan"), ("来る", "kuru"), ("出る", "ichidan"),
    ("入る", "godan"), ("出す", "godan"), ("持つ", "godan"),
    ("取る", "godan"), ("置く", "godan"), ("立つ", "godan"),
    ("座る", "godan"), ("寝る", "ichidan"), ("起きる", "ichidan"),
    ("開ける", "ichidan"), ("閉める", "ichidan"), ("始める", "ichidan"),
    ("終わる", "godan"), ("教える", "ichidan"), ("習う", "godan"),
    ("覚える", "ichidan"), ("忘れる", "ichidan"), ("考える", "ichidan"),
    ("知る", "godan"), ("会う", "godan"), ("遊ぶ", "godan"),
    ("泳ぐ", "godan"), ("飛ぶ", "godan"), ("死ぬ", "godan"),
    ("生きる", "ichidan"), ("売る", "godan"), ("払う", "godan"),
    ("送る", "godan"), ("届く", "godan"), ("着く", "godan"),
    ("乗る", "godan"), ("降りる", "ichidan"), ("渡る", "godan"),
    ("曲がる", "godan"), ("止まる", "godan"), ("動く", "godan"),
    ("変わる", "godan"), ("選ぶ", "godan"), ("決める", "ichidan"),
    ("答える", "ichidan"), ("尋ねる", "ichidan"), ("呼ぶ", "godan"),
    ("歌う", "godan"), ("踊る", "godan"), ("笑う", "godan"),
    ("泣く", "godan"), ("怒る", "godan"), ("喜ぶ", "godan"),
    ("困る", "godan"), ("疲れる", "ichidan"), ("休む", "godan"),
    ("洗う", "godan"), ("切る", "godan"), ("焼く", "godan"),
    ("煮る", "ichidan"), ("混ぜる", "ichidan"), ("並ぶ", "godan"),
    ("運ぶ", "godan"), ("押す", "godan"), ("引く", "godan"),
    ("投げる", "ichidan"), ("受ける", "ichidan"), ("打つ", "godan"),
    ("勝つ", "godan"), ("負ける", "ichidan"), ("戦う", "godan"),
    ("守る", "godan"), ("助ける", "ichidan"), ("探す", "godan"),
    ("見つける", "ichidan"), ("隠す", "godan"), ("捨てる", "ichidan"),
    ("拾う", "godan"), ("落ちる", "ichidan"), ("落とす", "godan"),
    ("上がる", "godan"), ("下がる", "godan"), ("登る", "godan"),
    ("晴れる", "ichidan"), ("曇る", "godan"), ("降る", "godan"),
    ("吹く", "godan"), ("光る", "godan"), ("消える", "ichidan"),
    ("消す", "godan"), ("点ける", "ichidan"), ("建てる", "ichidan"),
    ("壊す", "godan"), ("壊れる", "ichidan"), ("直す", "godan"),
    ("治る", "godan"), ("増える", "ichidan"), ("減る", "godan"),
    ("育てる", "ichidan"), ("育つ", "godan"), ("生まれる", "ichidan"),
    ("勉強する", "suru"), ("仕事する", "suru"), ("電話する", "suru"),
    ("料理する", "suru"), ("旅行する", "suru"), ("運動する", "suru"),
    ("練習する", "suru"), ("説明する", "suru"), ("紹介する", "suru"),
    ("準備する", "suru"), ("利用する", "suru"), ("研究する", "suru"),
]

I_ADJECTIVES = [
    "高い", "安い", "大きい", "小さい", "新しい", "古い", "良い",
    "悪い", "暑い", "寒い", "早い", "遅い", "美しい", "楽しい",
    "面白い", "難しい", "易しい", "多い", "少ない", "長い", "短い",
    "広い", "狭い", "重い", "軽い", "強い", "弱い", "明るい", "暗い",
    "近い", "遠い", "太い", "細い", "厚い", "薄い", "深い", "浅い",
    "甘い", "辛い", "苦い", "白い", "黒い", "赤い", "青い", "丸い",
    "若い", "忙しい", "嬉しい", "悲しい", "怖い", "眠い", "痛い",
    "汚い", "美味しい", "まずい", "うるさい", "正しい",
    "危ない", "優しい", "厳しい", "賢い", "可愛い", "凄い",
]

# irregular adjective surfaces the conjugator can't derive:
# 大きな/小さな are prenominal-only forms, いい/よく suppletive 良い
IRREGULAR_ADJ_FORMS = [("大きな", "大きい"), ("小さな", "小さい"),
                       ("いい", "良い"), ("よく", "良い")]

# conjugator outputs that don't exist in the language (the negation of
# ある is the bare adjective ない, not *あらない)
BOGUS_FORMS = {"あらない", "あらなかった"}

NA_ADJECTIVES = [
    "静か", "元気", "綺麗", "便利", "不便", "有名", "大切", "大変",
    "簡単", "複雑", "自由", "安全", "危険", "特別", "普通", "必要",
    "十分", "残念", "親切", "丁寧", "真面目", "熱心", "暇", "好き",
    "嫌い", "上手", "下手", "得意", "苦手",
]

NOUNS = [
    # people / society
    "学生", "先生", "学校", "会社", "社員", "医者", "警察", "店員",
    "家族", "父", "母", "兄", "弟", "姉", "妹", "息子", "娘", "夫",
    "妻", "友達", "子供", "大人", "男", "女", "人々", "皆",
    # places
    "日本", "東京", "京都", "大阪", "北海道", "沖縄", "アメリカ",
    "中国", "韓国", "フランス", "ドイツ", "イギリス", "国", "町",
    "村", "駅", "空港", "病院", "銀行", "図書館", "公園", "店",
    "レストラン", "ホテル", "大学", "教室", "部屋", "台所", "庭",
    "道", "橋", "建物", "場所", "世界", "地図",
    # nature / time
    "山", "川", "海", "空", "森", "林", "島", "石", "土", "火",
    "水", "風", "雨", "雪", "雲", "星", "月", "太陽", "天気",
    "季節", "春", "夏", "秋", "冬", "朝", "昼", "夜", "今日",
    "明日", "昨日", "今", "時間", "時計", "週末", "去年", "来年",
    "毎日", "毎週", "午前", "午後",
    # things
    "本", "新聞", "雑誌", "手紙", "写真", "絵", "音楽", "映画",
    "歌", "電話", "電車", "車", "自転車", "飛行機", "船", "荷物",
    "鞄", "財布", "服", "靴", "帽子", "眼鏡", "傘", "椅子", "机",
    "窓", "扉", "鍵", "箱", "紙", "鉛筆", "辞書", "言葉", "名前",
    "声", "音", "色", "形", "大きさ", "値段", "お金", "切符",
    # food
    "ご飯", "飯", "パン", "肉", "魚", "野菜", "果物", "卵", "牛乳",
    "茶", "お茶", "珈琲", "酒", "料理", "朝ご飯", "昼ご飯", "晩ご飯",
    "すもも", "もも", "林檎", "蜜柑", "葡萄",
    # body / abstract
    "体", "頭", "顔", "目", "耳", "口", "鼻", "手", "足", "心",
    "気持ち", "気分", "夢", "話", "質問", "答え", "問題", "宿題",
    "試験", "意味", "理由", "方法", "結果", "始め", "終わり",
    "仕事", "勉強", "旅行", "運動", "練習", "経験", "文化", "歴史",
    "社会", "政治", "経済", "科学", "技術", "自然", "動物", "犬",
    "猫", "鳥", "馬", "牛", "花", "木", "草", "うち", "家",
]

KATAKANA_LOANWORDS = [
    "コンピュータ", "インターネット", "メール", "テレビ", "ラジオ",
    "カメラ", "ニュース", "スポーツ", "サッカー", "テニス", "ピアノ",
    "ギター", "コンサート", "パーティー", "プレゼント", "ケーキ",
    "コーヒー", "ジュース", "ビール", "ワイン", "バス", "タクシー",
    "ホテル", "デパート", "スーパー", "コンビニ", "アパート", "ビル",
    "エレベーター", "トイレ", "シャワー", "ベッド", "テーブル",
    "ドア", "ページ", "ペン", "ノート", "クラス", "テスト", "レポート",
    "アルバイト", "サービス", "システム", "データ", "プログラム",
]

PRONOUNS = ["私", "僕", "君", "彼", "彼女", "これ", "それ", "あれ",
            "ここ", "そこ", "あそこ", "どこ", "誰", "何", "いつ",
            "どれ", "こちら", "そちら", "あなた", "我々", "自分"]

ADVERBS = ["とても", "すごく", "もっと", "少し", "たくさん", "いつも",
           "また", "まだ", "もう", "すぐ", "ゆっくり", "一緒に",
           "時々", "よく", "たぶん", "きっと", "必ず", "全然",
           "あまり", "ちょっと", "だいたい", "はっきり", "そろそろ",
           "やはり", "やっぱり", "実は", "例えば", "特に", "最近",
           "初めて", "突然", "急に"]

PARTICLES = ["は", "が", "を", "に", "で", "と", "も", "の", "へ",
             "や", "から", "まで", "より", "ね", "よ", "か", "な",
             "ば", "ても", "でも", "だけ", "しか", "など", "って",
             "ながら", "けど", "のに", "ので", "とか", "ずつ", "くらい",
             "ぐらい", "ほど", "ばかり", "こそ", "さえ", "のみ"]

AUXILIARIES = [
    ("です", "です"), ("でした", "です"), ("でしょう", "です"),
    ("だ", "だ"), ("だった", "だ"), ("だろう", "だ"),
    ("ます", "ます"), ("ました", "ます"), ("ません", "ます"),
    ("ましょう", "ます"), ("まし", "ます"),
    ("た", "た"), ("ない", "ない"), ("なかった", "ない"),
    ("れる", "れる"), ("られる", "られる"), ("せる", "せる"),
    ("させる", "させる"), ("たい", "たい"), ("たかった", "たい"),
    ("う", "う"), ("よう", "よう"), ("そう", "そう"),
    ("らしい", "らしい"), ("みたい", "みたい"), ("はず", "はず"),
    ("べき", "べき"), ("かもしれない", "かもしれない"),
]

PREFIXES = ["お", "ご", "真", "小", "大"]
SUFFIXES = ["さん", "ちゃん", "君", "様", "たち", "都", "府", "県",
            "市", "区", "町", "村", "語", "人", "屋", "的", "者",
            "中", "後", "前", "際", "式", "製", "用", "家", "員",
            "品", "料", "代", "費", "店", "場", "側", "歳", "回",
            "階", "番", "号", "度", "個", "匹", "冊", "枚", "台",
            "杯", "本"]


def build_entries(pos_names) -> Entries:
    """Expand the seed data into lattice entries. ``pos_names`` supplies
    the POS constants (avoids a circular import with lattice_tokenizer)."""
    P = pos_names
    lex: Entries = {}

    def add(surface, pos, cost, base=None):
        lex.setdefault(surface, []).append((pos, cost, base or surface))

    for p in PARTICLES:
        add(p, P["PARTICLE"], 200)
    for a, base in AUXILIARIES:
        add(a, P["AUX"], 300, base)
    for n in PRONOUNS:
        add(n, P["PRONOUN"], 700)
    for n in NOUNS:
        add(n, P["NOUN"], 800)
    for n in KATAKANA_LOANWORDS:
        add(n, P["NOUN"], 750)
    for n in NA_ADJECTIVES:
        # na-adjective stems behave like nouns in the lattice (attach
        # な/に/です); tagged adjective for consumers
        add(n, P["ADJ"], 850)
    for a in ADVERBS:
        add(a, P["ADV"], 900)
    for v, klass in VERBS:
        for surface, kind in conjugate_verb(v, klass):
            if surface in BOGUS_FORMS:
                continue
            pos = P["VERB"] if kind == "dict" else P["VERB_INFL"]
            # dictionary forms slightly preferred; particles must still
            # beat single-kana inflections (cost ordering as before)
            add(surface, pos, 900 if kind == "dict" else 950, v)
    for a in I_ADJECTIVES:
        for surface, kind in conjugate_i_adjective(a):
            add(surface, P["ADJ"], 900 if kind == "dict" else 930, a)
    for surface, base in IRREGULAR_ADJ_FORMS:
        add(surface, P["ADJ"], 900, base)
    for p in PREFIXES:
        add(p, P["PREFIX"], 1200)
    for s in SUFFIXES:
        add(s, P["SUFFIX"], 900)
    return lex


# ---------------------------------------------------------------------------
# r5 scale-up (VERDICT r4 #10): suru-verbal-nouns, counters with generated
# kanji numerals, and broader seed vocabulary — same generative philosophy,
# an order of magnitude more coverage.
# ---------------------------------------------------------------------------

# Sino-Japanese verbal nouns: each contributes the bare noun AND its full
# する-compound paradigm (the reference's IPADIC tags these サ変接続).
SURU_NOUNS = [
    "愛", "安心", "案内", "意味", "移動", "違反", "一致", "印刷",
    "引退", "運転", "運搬", "営業", "影響", "衛生", "演奏", "遠慮",
    "応援", "応対", "横断", "解決", "開催", "開始", "解釈", "回収",
    "改善", "開発", "回復", "開放", "確認", "学習", "拡大", "確立",
    "加入", "我慢", "観光", "感謝", "完成", "乾燥", "感動", "管理",
    "帰国", "記入", "記念", "寄付", "希望", "決定", "見学", "研究",
    "検査", "建設", "見物", "交換", "講義", "合格", "貢献", "工事",
    "構成", "行動", "興奮", "誤解", "故障", "卒業", "混乱", "再生",
    "作成", "撮影", "参加", "賛成", "散歩", "試合", "指導", "支配",
    "失敗", "質問", "指定", "辞退", "実行", "実現", "失礼", "指摘",
    "支払", "借金", "集中", "修理", "出発", "出席", "準備", "紹介",
    "消費", "証明", "使用", "食事", "処理", "信頼", "心配", "診察",
    "進歩", "推薦", "生活", "制限", "成功", "清掃", "製造", "成長",
    "整理", "説明", "選挙", "宣伝", "専攻", "洗濯", "選択", "想像",
    "相談", "送信", "増加", "掃除", "尊敬", "対応", "滞在",
    "代表", "逮捕", "達成", "注意", "注文", "調査", "調整", "貯金",
    "通勤", "通訳", "提案", "停止", "提出", "訂正", "徹底", "手配",
    "転勤", "電話", "投票", "登録", "独立", "努力", "納得", "入院",
    "入学", "入力", "確保", "破壊", "拍手", "発見", "発表", "発明",
    "反対", "判断", "比較", "批判", "評価", "表現", "不足", "負担",
    "復習", "分析", "分類", "変化", "勉強", "変更", "報告", "防止",
    "放送", "訪問", "保証", "保存", "翻訳", "満足", "無視", "命令",
    "面接", "目撃", "輸出", "輸入", "用意", "要求", "予習", "予想",
    "予定", "予約", "利用", "理解", "留学", "料理", "旅行", "連絡",
    "録音", "録画", "割引", "経営", "計画", "経験", "計算", "契約",
    "結婚", "欠席", "検討", "限定", "交渉", "更新", "構築", "肯定",
    "否定", "招待", "消化", "乗車", "下車", "上陸", "申請", "生産",
    "接続", "設置", "設定", "説得", "節約", "測定", "対策", "担当",
    "中止", "中断", "駐車", "追加", "通知", "展開", "展示", "伝達",
    "統一", "同意", "導入", "討論", "読書", "納入", "配達", "配布",
    "廃止", "発生", "発達", "販売", "避難", "勃発", "保護", "募集",
    "補償", "埋葬", "約束", "誘導", "優勝", "輸送", "容認", "抑制",
    "来日", "落下", "離陸", "着陸", "了解", "練習", "老化", "協力",
    "共有", "記録", "禁止", "緊張", "苦労", "訓練", "敬意", "警告",
    "化粧", "下宿", "外出", "回答", "拡張", "活動", "活躍", "仮定",
    "感染", "完了", "観察", "鑑賞", "企画", "期待", "機能", "救助",
    "供給", "強調", "勤務", "区別", "軽減", "掲載", "継続", "決意",
    "決済", "解説", "建築", "公開", "攻撃", "広告", "考慮", "呼吸",
    "告白", "混雑", "採用", "削除", "作業", "差別", "支援", "刺激",
    "試験", "自殺", "持参", "実施", "実験", "執筆", "指名", "射撃",
    "収穫", "収集", "就職", "渋滞", "祝福", "受験", "手術", "出勤",
    "出場", "出張", "昇進", "承認", "勝利", "除去", "所有", "自立",
    "侵入", "遂行", "睡眠", "請求", "制作", "正解", "成立", "設計",
    "接近", "宣言", "専念", "戦争", "送金", "遭遇", "操作", "装備",
    "組織", "訴訟", "存在", "尊重", "退院", "退職", "対立", "妥協",
    "脱出", "探検", "誕生", "断念", "遅刻", "治療", "沈黙", "適応",
    "適用", "徹夜", "転換", "伝染", "転送", "倒産", "到着", "同居",
    "登場", "討議", "逃亡", "同伴", "突入", "把握", "買収", "排除",
    "拝見", "配慮", "爆発", "発揮", "発行", "発射", "反映", "反抗",
    "反省", "被害", "飛行", "筆記", "避暑", "普及", "復活", "復帰",
    "分解", "分担", "閉店", "返却", "返済", "返事", "変身", "保管",
    "募金", "暴露", "摩擦", "満喫", "見舞", "矛盾", "迷惑", "申込",
    "模倣", "躍進", "誘拐", "遊泳", "養成", "抑圧", "落胆", "乱用",
    "理想", "立証", "略奪", "療養", "連携", "連想", "連続", "露出",
    "論証", "妥結", "開拓", "格納", "合併", "帰宅", "帰省", "急増",
    "凝視", "苦戦", "激減", "激増", "検索", "交代", "誤操作", "再会",
    "在庫", "裁判", "試食", "持続", "失望", "受信", "瞬間移動", "上演",
    "伸張", "推進", "寸断", "先行", "全滅", "蘇生", "妥当化", "宅配",
    "探索", "追跡", "沈下", "痛感", "展望", "徒歩", "搭載", "内蔵",
    "燃焼", "波及", "買い物", "発酵", "無効", "比例", "浮上",
    "分布", "平行", "崩壊", "膨張", "密集", "黙認", "油断", "濾過",
]
# defensively drop anything that isn't pure CJK/kana (typo guard)
SURU_NOUNS = [n for n in SURU_NOUNS if all(ord(c) > 0x2E7F for c in n)]

VERBS_EXTRA = [
    ("急ぐ", "godan"), ("稼ぐ", "godan"), ("騒ぐ", "godan"),
    ("脱ぐ", "godan"), ("防ぐ", "godan"), ("繋ぐ", "godan"),
    ("頼む", "godan"), ("包む", "godan"), ("悩む", "godan"),
    ("進む", "godan"), ("盗む", "godan"), ("畳む", "godan"),
    ("噛む", "godan"), ("挟む", "godan"), ("望む", "godan"),
    ("叫ぶ", "godan"), ("転ぶ", "godan"), ("結ぶ", "godan"),
    ("学ぶ", "godan"), ("浮かぶ", "godan"), ("滅ぶ", "godan"),
    ("勝る", "godan"), ("謝る", "godan"), ("祈る", "godan"),
    ("送る", "godan"), ("断る", "godan"), ("触る", "godan"),
    ("眠る", "godan"), ("残る", "godan"), ("移る", "godan"),
    ("写る", "godan"), ("戻る", "godan"), ("参る", "godan"),
    ("回る", "godan"), ("通る", "godan"), ("光る", "godan"),
    ("頑張る", "godan"), ("握る", "godan"), ("縛る", "godan"),
    ("削る", "godan"), ("蹴る", "godan"), ("滑る", "godan"),
    ("喋る", "godan"), ("捻る", "godan"), ("混じる", "godan"),
    ("走り回る", "godan"), ("振る", "godan"), ("張る", "godan"),
    ("貼る", "godan"), ("釣る", "godan"), ("積もる", "godan"),
    ("渡す", "godan"), ("許す", "godan"), ("返す", "godan"),
    ("倒す", "godan"), ("回す", "godan"), ("移す", "godan"),
    ("残す", "godan"), ("流す", "godan"), ("乾かす", "godan"),
    ("動かす", "godan"), ("驚かす", "godan"), ("冷やす", "godan"),
    ("増やす", "godan"), ("減らす", "godan"), ("鳴らす", "godan"),
    ("照らす", "godan"), ("貸す", "godan"), ("試す", "godan"),
    ("指す", "godan"), ("刺す", "godan"), ("差す", "godan"),
    ("示す", "godan"), ("外す", "godan"), ("話し合う", "godan"),
    ("笑い合う", "godan"), ("向かう", "godan"), ("従う", "godan"),
    ("戦う", "godan"), ("疑う", "godan"), ("扱う", "godan"),
    ("救う", "godan"), ("吸う", "godan"), ("誘う", "godan"),
    ("迷う", "godan"), ("通う", "godan"), ("願う", "godan"),
    ("祝う", "godan"), ("狙う", "godan"), ("奪う", "godan"),
    ("飼う", "godan"), ("雇う", "godan"), ("味わう", "godan"),
    ("呟く", "godan"), ("頷く", "godan"), ("輝く", "godan"),
    ("驚く", "godan"), ("招く", "godan"), ("叩く", "godan"),
    ("抱く", "godan"), ("描く", "godan"), ("磨く", "godan"),
    ("乾く", "godan"), ("渇く", "godan"), ("続く", "godan"),
    ("気づく", "godan"), ("近づく", "godan"), ("傷つく", "godan"),
    ("片づく", "godan"), ("基づく", "godan"), ("咲く", "godan"),
    ("泣き出す", "godan"), ("打つ", "godan"), ("育つ", "godan"),
    ("保つ", "godan"), ("放つ", "godan"), ("目立つ", "godan"),
    ("役立つ", "godan"), ("旅立つ", "godan"),
    ("避ける", "ichidan"), ("続ける", "ichidan"), ("届ける", "ichidan"),
    ("片付ける", "ichidan"), ("見つめる", "ichidan"), ("眺める", "ichidan"),
    ("諦める", "ichidan"), ("集める", "ichidan"), ("認める", "ichidan"),
    ("進める", "ichidan"), ("勧める", "ichidan"), ("薦める", "ichidan"),
    ("止める", "ichidan"), ("辞める", "ichidan"), ("温める", "ichidan"),
    ("冷める", "ichidan"), ("覚める", "ichidan"), ("納める", "ichidan"),
    ("収める", "ichidan"), ("治める", "ichidan"), ("求める", "ichidan"),
    ("高める", "ichidan"), ("深める", "ichidan"), ("広める", "ichidan"),
    ("強める", "ichidan"), ("弱める", "ichidan"), ("確かめる", "ichidan"),
    ("慰める", "ichidan"), ("褒める", "ichidan"), ("責める", "ichidan"),
    ("攻める", "ichidan"), ("染める", "ichidan"), ("占める", "ichidan"),
    ("締める", "ichidan"), ("絞める", "ichidan"), ("詰める", "ichidan"),
    ("見せる", "ichidan"), ("任せる", "ichidan"), ("乗せる", "ichidan"),
    ("載せる", "ichidan"), ("寄せる", "ichidan"), ("合わせる", "ichidan"),
    ("知らせる", "ichidan"), ("済ませる", "ichidan"), ("痩せる", "ichidan"),
    ("見える", "ichidan"), ("聞こえる", "ichidan"), ("燃える", "ichidan"),
    ("越える", "ichidan"), ("超える", "ichidan"), ("植える", "ichidan"),
    ("飢える", "ichidan"), ("迎える", "ichidan"), ("支える", "ichidan"),
    ("加える", "ichidan"), ("数える", "ichidan"), ("抑える", "ichidan"),
    ("押さえる", "ichidan"), ("捕まえる", "ichidan"), ("間違える", "ichidan"),
    ("着替える", "ichidan"), ("乗り換える", "ichidan"), ("振り返る", "godan"),
    ("繰り返す", "godan"), ("取り出す", "godan"), ("引き出す", "godan"),
    ("思い出す", "godan"), ("見つかる", "godan"), ("助かる", "godan"),
    ("見つけ出す", "godan"), ("受け取る", "godan"), ("受け入れる", "ichidan"),
    ("取り入れる", "ichidan"), ("手に入れる", "ichidan"), ("入れる", "ichidan"),
    ("倒れる", "ichidan"), ("汚れる", "ichidan"), ("濡れる", "ichidan"),
    ("折れる", "ichidan"), ("切れる", "ichidan"), ("割れる", "ichidan"),
    ("破れる", "ichidan"), ("外れる", "ichidan"), ("離れる", "ichidan"),
    ("流れる", "ichidan"), ("触れる", "ichidan"), ("暮れる", "ichidan"),
    ("晴れ上がる", "godan"), ("慣れる", "ichidan"), ("現れる", "ichidan"),
    ("表れる", "ichidan"), ("優れる", "ichidan"), ("遅れる", "ichidan"),
]

I_ADJECTIVES_EXTRA = [
    "嬉しい", "寂しい", "淋しい", "恥ずかしい", "懐かしい", "羨ましい",
    "恐ろしい", "騒がしい", "おとなしい", "親しい", "詳しい", "等しい",
    "激しい", "険しい", "貧しい", "珍しい", "柔らかい", "硬い",
    "温かい", "暖かい", "冷たい", "涼しい", "蒸し暑い", "熱い",
    "丸っこい", "鋭い", "鈍い", "濃い", "緩い", "きつい", "ゆるい",
    "細かい", "粗い", "荒い", "偉い", "賢明らしい", "幼い", "醜い",
    "清い", "汚らしい", "だるい", "かゆい", "しつこい", "ずるい",
    "もろい", "煙たい", "重たい", "眩しい", "苦しい", "悔しい",
    "頼もしい", "相応しい", "好ましい", "望ましい", "勇ましい",
]
I_ADJECTIVES_EXTRA = [a for a in I_ADJECTIVES_EXTRA if a.endswith("い")]

NA_ADJECTIVES_EXTRA = [
    "丈夫", "大丈夫", "立派", "素敵", "素直", "正直", "確か", "豊か",
    "穏やか", "爽やか", "鮮やか", "賑やか", "滑らか", "華やか",
    "柔軟", "頑固", "曖昧", "明確", "正確", "適当", "適切", "重要",
    "重大", "貴重", "高価", "豪華", "質素", "地味", "派手", "新鮮",
    "清潔", "不潔", "健康", "幸せ", "不幸", "幸運", "不運", "可能",
    "不可能", "無理", "無駄", "無事", "平気", "平和", "公平", "平等",
    "自然", "当然", "突然", "偶然", "急", "変", "楽", "楽観的",
    "悲観的", "積極的", "消極的", "具体的", "抽象的", "基本的",
    "一般的", "個人的", "国際的", "伝統的", "現代的", "科学的",
]

NOUNS_EXTRA = [
    "政府", "国家", "国民", "市民", "選手", "監督", "俳優", "歌手",
    "作家", "画家", "記者", "教授", "博士", "科学者", "研究者",
    "技術者", "弁護士", "看護師", "運転手", "消防士", "公務員",
    "会議", "会話", "議論", "意見", "情報", "知識", "能力", "才能",
    "性格", "習慣", "常識", "印象", "感情", "感覚", "記憶", "想像",
    "現実", "事実", "真実", "嘘", "秘密", "噂", "物語", "小説",
    "詩", "芸術", "演劇", "舞台", "番組", "広場", "通り", "交差点",
    "信号", "標識", "地下鉄", "新幹線", "切手", "葉書", "封筒",
    "書類", "資料", "記事", "文章", "文字", "漢字", "平仮名",
    "片仮名", "文法", "発音", "翻訳", "辞典", "教科書", "宿題",
    "授業", "講座", "科目", "数学", "物理", "化学", "生物", "地理",
    "地震", "台風", "洪水", "火事", "事故", "事件", "犯罪", "泥棒",
    "警官", "裁判所", "法律", "規則", "制度", "権利", "義務", "自由",
    "責任", "約束", "契約", "条件", "目的", "目標", "計画", "予算",
    "費用", "収入", "支出", "給料", "税金", "価格", "割合", "数字",
    "統計", "平均", "合計", "距離", "速度", "重さ", "高さ", "深さ",
    "広さ", "温度", "気温", "湿度", "環境", "公害", "資源",
    "電気", "電力", "石油", "石炭", "金属", "鉄", "銀", "金",
    "銅", "ガラス", "プラスチック", "木材", "布", "糸", "針",
    "道具", "機械", "装置", "設備", "工場", "倉庫", "事務所",
    "支店", "本社", "工業", "農業", "漁業", "商業", "貿易",
    "産業", "企業", "組合", "組織", "団体", "委員会", "政党",
    "選挙", "投票", "大統領", "首相", "大臣", "議員", "憲法",
    "戦争", "平和", "軍隊", "兵士", "武器", "爆弾", "被害",
    "病気", "風邪", "熱", "咳", "怪我", "傷", "薬", "注射",
    "手術", "治療", "健康", "症状", "血", "骨", "筋肉", "皮膚",
    "心臓", "胃", "肺", "脳", "神経", "細胞", "栄養", "疲労",
    "睡眠", "休憩", "散歩", "運動会", "祭り", "行事", "儀式",
    "結婚式", "葬式", "誕生日", "記念日", "正月", "休日", "祝日",
    "平日", "曜日", "月曜日", "火曜日", "水曜日", "木曜日",
    "金曜日", "土曜日", "日曜日", "今週", "先週", "来週", "今月",
    "先月", "来月", "今年", "昔", "未来", "将来", "過去", "現在",
    "最初", "最後", "途中", "瞬間", "期間", "時代", "世紀", "年代",
    "隣", "向かい", "周り", "辺り", "奥", "表", "裏", "左", "右",
    "東", "西", "南", "北", "上", "下", "中", "外", "内", "間",
    "部長", "社長", "課長", "係長", "店長", "院長", "校長", "全員",
    "全部", "全体", "一部", "半分", "最終", "最高", "最低", "最大",
    "最小", "当時", "当日", "今回", "前回", "次回", "毎回", "本日",
    "本人", "本当", "相手", "様子", "状態", "状況", "結論", "結局",
]

# NB: the long-vowel mark ー is NOT punctuation — a cheap symbol entry
# would shred unknown katakana runs (ヘリコプター -> ヘリコプタ + ー)
PUNCTUATION = ["。", "、", "！", "？", "・", "「", "」", "『", "』",
               "（", "）", "…", "〜"]

KATAKANA_EXTRA = [
    "アイデア", "アクセス", "アドバイス", "アナウンス", "アニメ",
    "アルバム", "イベント", "イメージ", "エネルギー", "エンジン",
    "オフィス", "オレンジ", "カード", "カレンダー", "キッチン",
    "キャンプ", "クイズ", "クッキー", "グラフ", "グループ",
    "ゲーム", "コース", "コピー", "コメント", "コンピューター",
    "サイズ", "サイン", "サラダ", "サンドイッチ", "シャツ",
    "シリーズ", "スーツ", "スケジュール", "スタイル", "ステージ",
    "ストレス", "スピード", "スマホ", "セール", "セット",
    "ソフト", "タイプ", "タイトル", "チーム", "チャンス",
    "チケット", "チョコレート", "ツアー", "デザイン", "デジタル",
    "トマト", "トラック", "トンネル", "ドラマ", "ナイフ",
    "ネクタイ", "ネット", "バイク", "バター", "バッグ",
    "バランス", "パスポート", "パソコン", "ビデオ", "ファイル",
    "ファン", "フォーク", "ブログ", "プール", "プラン",
    "ブランド", "プリント", "ペット", "ベンチ", "ボール",
    "ボタン", "ポケット", "ポスター", "マスク", "マナー",
    "ミルク", "メニュー", "メンバー", "モデル", "ユーモア",
    "ラーメン", "ライト", "ランチ", "リスト", "リズム",
    "ルール", "レベル", "レモン", "ロボット", "ワード",
]

COUNTERS = [
    "人", "本", "枚", "台", "冊", "匹", "頭", "羽", "個", "歳",
    "才", "回", "度", "階", "番", "号", "分", "秒", "時", "時間",
    "日", "週間", "月", "ヶ月", "年", "年間", "円", "ドル", "メートル",
    "キロ", "グラム", "リットル", "センチ", "ミリ", "点", "杯",
    "足", "着", "軒", "戸", "通", "件", "部", "課", "丁目", "番地",
    "割", "倍", "位", "等", "席", "名", "組", "社", "校", "店",
    "国", "箇所", "ページ", "行", "語", "文字", "曲", "品", "種類",
]

_KANJI_DIGITS = ["", "一", "二", "三", "四", "五", "六", "七", "八", "九"]


def kanji_numerals() -> List[str]:
    """Kanji numerals 1-99 plus the common power-of-ten heads — generated,
    exactly how a human derives them (IPADIC lists these explicitly)."""
    out = []
    for n in range(1, 200):
        hundreds, rest = divmod(n, 100)
        tens, ones = divmod(rest, 10)
        s = "百" if hundreds else ""
        if tens > 1:
            s += _KANJI_DIGITS[tens]
        if tens >= 1:
            s += "十"
        s += _KANJI_DIGITS[ones]
        out.append(s)
    out += ["百", "二百", "三百", "五百", "八百", "千", "三千", "五千",
            "八千", "一万", "十万", "百万", "千万", "一億", "何", "数"]
    return list(dict.fromkeys(out))


def build_entries_extended(pos_names) -> Entries:
    """build_entries plus the r5 scale-up: suru-compounds, extra seed
    vocabulary, and numeral+counter compounds. >=20k unique surfaces."""
    P = pos_names
    lex = build_entries(P)

    def add(surface, pos, cost, base=None):
        entry = (pos, cost, base or surface)
        bucket = lex.setdefault(surface, [])
        if entry not in bucket:  # seed lists overlap; no duplicate arcs
            bucket.append(entry)

    for n in SURU_NOUNS:
        add(n, P["NOUN"], 800)
        for surface, kind in conjugate_verb(n + "する", "suru"):
            pos = P["VERB"] if kind == "dict" else P["VERB_INFL"]
            add(surface, pos, 900 if kind == "dict" else 950, n + "する")
    for v, klass in VERBS_EXTRA:
        for surface, kind in conjugate_verb(v, klass):
            if surface in BOGUS_FORMS:
                continue
            pos = P["VERB"] if kind == "dict" else P["VERB_INFL"]
            add(surface, pos, 900 if kind == "dict" else 950, v)
    for a in I_ADJECTIVES_EXTRA:
        for surface, kind in conjugate_i_adjective(a):
            add(surface, P["ADJ"], 900 if kind == "dict" else 930, a)
    for n in NA_ADJECTIVES_EXTRA:
        add(n, P["ADJ"], 850)
    for n in NOUNS_EXTRA:
        # single-kanji positional nouns (中, 上, ...) would out-bid
        # unknown-word runs and shred unseen names like 田中 — they stay
        # suffix-only, exactly as before the scale-up
        if len(n) > 1:
            add(n, P["NOUN"], 800)
    for n in KATAKANA_EXTRA:
        add(n, P["NOUN"], 750)
    for p in PUNCTUATION:
        add(p, P["SYMBOL"], 100)
    nums = kanji_numerals()
    for num in nums:
        add(num, P["NUMBER"], 850)
        for c in COUNTERS:
            # numeral+counter compounds (一人, 三十五人, 二百円...) — the
            # slightly-below-noun cost beats prefix+suffix assembly
            add(num + c, P["NUMBER"], 820, num + c)
    return lex
